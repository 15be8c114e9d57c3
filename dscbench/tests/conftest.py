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


# the top-K comparison (no top-K cell yet: PERF.md, Open questions): the
# dense cell's files under the top-K plan from K = 32, and these checks
TOPK_CHECKS = {"vote": 1e-05, "tsa2_d": 1e-06, "segments": 0, "topk_k": 0,
               "topk_lists": 0, "thresholds": 1e-05, "labels": 0}


def load(name):
    """A cell by name; ``brest.topk`` is ``brest.dense`` under the fused
    top-K plan."""
    from dscbench import harness
    if name != "brest.topk":
        return harness.load_cell(name)
    cell = harness.load_cell("brest.dense")
    cell.spec = dict(cell.spec, checks=TOPK_CHECKS,
                     end_to_end=["job_ms", "peak_gb", "setup_s"])
    cell.plan = dict(cell.plan, sim_mode="topk", sim_topk=32)
    return cell


@pytest.fixture
def tiny_cell():
    return lambda name: tiny(load(name))
