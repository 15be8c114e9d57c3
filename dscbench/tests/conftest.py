"""Shared fixtures of the benchmark's own tests: a tiny cell on the CPU.

Run from the root of the checkout: ``python -m pytest dscbench/tests``.
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SEED = 2**31 + 17   # wider than 32 signed bits, as the driver's are


def tiny(cell, n_trajs=96, max_points=64, w=6):
    """The cell with its configuration cut to a size the CPU runs in
    about a second (widths as stated, scale cut)."""
    cell = copy.deepcopy(cell)
    cell.config["n_trajs"] = n_trajs
    cell.config["data"]["max_points"] = max_points
    cell.config["params"]["w"] = w
    return cell


@pytest.fixture
def tiny_cell():
    from dscbench import harness
    return lambda name: tiny(harness.load_cell(name))
