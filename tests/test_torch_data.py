"""PyTorch port: the data model and the generators, held against the JAX
package.  The generators are numpy draw for draw, so batches must be
bitwise equal on the same seed."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.core.types import DSCParams, TrajectoryBatch
from repro_torch.data import synthetic as tsyn

torch.set_num_threads(1)

FIELDS = ("x", "y", "t", "valid", "traj_id")
ROOT = Path(__file__).resolve().parents[1]


def _assert_same_batch(jb, tb):
    for f in FIELDS:
        a = np.asarray(getattr(jb, f))
        b = getattr(tb, f).numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("n_per_route,points_per_leg,seed,pad", [
    (4, 24, 0, None), (2, 24, 3, None), (1, 8, 5, 10), (3, 16, 2, None)])
def test_figure1_bitwise(n_per_route, points_per_leg, seed, pad):
    jb, jl = jsyn.figure1_scenario(n_per_route=n_per_route,
                                   points_per_leg=points_per_leg, seed=seed,
                                   pad_trajs_to=pad)
    tb, tl = tsyn.figure1_scenario(n_per_route=n_per_route,
                                   points_per_leg=points_per_leg, seed=seed,
                                   pad_trajs_to=pad, device="cpu")
    _assert_same_batch(jb, tb)
    assert np.array_equal(jl, tl)


@pytest.mark.parametrize("seed", [2, 7])
def test_crossing_bitwise(seed):
    jb, jl, je = jsyn.crossing_scenario(seed=seed)
    tb, tl, te = tsyn.crossing_scenario(seed=seed, device="cpu")
    _assert_same_batch(jb, tb)
    assert np.array_equal(jl, tl) and np.array_equal(je, te)


@pytest.mark.parametrize("n,M,seed,lanes", [(24, 96, 1, 4), (16, 64, 0, 8),
                                            (9, 33, 4, 2)])
def test_ais_bitwise(n, M, seed, lanes):
    jb, jl = jsyn.ais_like(n_vessels=n, max_points=M, seed=seed,
                           n_lanes=lanes)
    tb, tl = tsyn.ais_like(n_vessels=n, max_points=M, seed=seed,
                           n_lanes=lanes, device="cpu")
    _assert_same_batch(jb, tb)
    assert np.array_equal(jl, tl)


def test_from_arrays_round_trip():
    tb, _ = tsyn.ais_like(n_vessels=7, max_points=20, seed=3, device="cpu")
    arrays = [getattr(tb, f).numpy() for f in FIELDS]
    back = TrajectoryBatch.from_arrays(*arrays, device="cpu")
    for f, a in zip(FIELDS, arrays):
        assert np.array_equal(getattr(back, f).numpy(), a), f
    assert back.num_trajs == 7 and back.max_points == 20
    assert np.array_equal(back.count.numpy(), arrays[3].sum(1))


def test_from_numpy_sorts_and_truncates():
    rng = np.random.default_rng(0)
    trajs = [rng.uniform(0, 1, (n, 3)) for n in (5, 9, 3)]
    from repro.core.types import TrajectoryBatch as JB
    _assert_same_batch(JB.from_numpy(trajs, max_points=6, pad_trajs_to=4),
                       TrajectoryBatch.from_numpy(trajs, max_points=6,
                                                  pad_trajs_to=4,
                                                  device="cpu"))


@pytest.mark.parametrize("which", ["fig1", "ais"])
def test_default_dsc_params_for(which, fig1, ais):
    jb = fig1[0] if which == "fig1" else ais[0]
    tb = TrajectoryBatch.from_arrays(*(np.asarray(getattr(jb, f))
                                       for f in FIELDS), device="cpu")
    assert jsyn.default_dsc_params_for(jb) == tsyn.default_dsc_params_for(tb)


def test_params_replace():
    p = DSCParams(eps_sp=0.3).replace(w=4)
    assert (p.eps_sp, p.w, p.segmentation) == (0.3, 4, "tsa1")


def test_no_card_means_no_silent_cpu(monkeypatch):
    """With no card, the card default raises instead of using the CPU."""
    from repro_torch.core.dsc import run_dsc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tb, _ = tsyn.figure1_scenario(n_per_route=1, points_per_leg=8,
                                  device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_dsc(tb, DSCParams())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsyn.figure1_scenario(n_per_route=1, points_per_leg=8)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n in ("jax", "repro") or n.startswith(("jax.", "repro.")))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_imports_neither_jax_nor_repro():
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert "repro_torch" in roots
