"""PyTorch port: the time-window skip of the panel passes K7 / K13.

The kernels skip a (group of 8 consecutive reference points, chunk of 8
candidate points) pair only when their time bounds are farther apart than
eps_t.  Their plain mirror (``stjoin/ref.py``: ``chunk_time_bounds``,
``panel_skip_ref``, ``panel_skip_counts_ref``) is held here against brute
force: the bounds equal a min / max over the valid points, and no skipped
pair holds a point pair with ``|fl(t_p - t_q)| <= eps_t`` (float32, the
pair test's own subtraction), on adversarial times.  The prepared panel
pass (``SimPanelSweep``) equals the public wrapper, the plain K4 ``raw``
and the JAX package's panel pass; its skip counts equal the mirror's over
the pairs it names.  Exact comparisons throughout, except against the JAX
package (1e-5 absolute: ROADMAP queue 3, the cell sums' order).
"""
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.kernels.stjoin import ops as jops
from repro_torch.core.types import TrajectoryBatch
from repro_torch.kernels.stjoin import ops as tops
from repro_torch.kernels.stjoin.ref import (chunk_time_bounds,
                                            panel_skip_counts_ref,
                                            panel_skip_ref)

torch.set_num_threads(1)

ATOL = 1e-5
CH = tops.PANEL_CHUNK
BATCH = ("x", "y", "t", "valid", "traj_id")


def _port(jb):
    return TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in BATCH), device="cpu")


@pytest.mark.parametrize("R,N,chunk", [(5, 37, 8), (3, 64, 8), (4, 10, 3),
                                       (2, 1, 8)])
def test_chunk_bounds_brute_force(R, N, chunk):
    """``chunk_time_bounds`` equals a min / max over each run's valid,
    non-NaN times, and (+inf, -inf) for a run without one."""
    rng = np.random.default_rng(R * N + chunk)
    t = rng.uniform(-1e3, 1e3, (R, N)).astype(np.float32)
    t[rng.uniform(size=(R, N)) < 0.1] = np.nan
    ok = rng.uniform(size=(R, N)) < 0.7
    ok[0] = False                                  # a row of padding
    lo, hi = chunk_time_bounds(torch.from_numpy(t), torch.from_numpy(ok),
                               chunk)
    n = -(-N // chunk)
    assert lo.shape == hi.shape == (R, n)
    for r in range(R):
        for k in range(n):
            v = t[r, k * chunk:(k + 1) * chunk]
            v = v[ok[r, k * chunk:(k + 1) * chunk] & ~np.isnan(v)]
            want = (v.min(), v.max()) if v.size else (np.inf, -np.inf)
            assert (float(lo[r, k]), float(hi[r, k])) == want, (r, k)


def _times(case, rng, T, M):
    """``(t [T, M] f32, ok [T, M], eps_t)`` of one adversarial case."""
    ok = rng.uniform(size=(T, M)) < 0.85
    eps = 60.0
    if case == "at_eps":
        # times on a grid of eps_t: many pairs exactly +-eps_t apart
        t = (rng.integers(0, 40, (T, M)) * eps).astype(np.float32)
        t.sort(axis=1)
    elif case == "epoch":
        # near 1.7e9 the float32 spacing is 128 s: dt is 0 or >= 128
        t = (1.7e9 + np.cumsum(rng.uniform(0, 200, (T, M)), 1)).astype(
            np.float32)
    elif case == "unsorted":
        t = rng.uniform(0, 3000, (T, M)).astype(np.float32)
    elif case == "padding":
        t = np.sort(rng.uniform(0, 3000, (T, M)), 1).astype(np.float32)
        ok[::3] = False                            # all-padding rows
    elif case == "eps0":
        t = (rng.integers(0, 30, (T, M)) * 7.0).astype(np.float32)
        t.sort(axis=1)
        eps = 0.0
    else:
        raise ValueError(case)
    return t, ok, eps


@pytest.mark.parametrize("case", ["at_eps", "epoch", "unsorted", "padding",
                                  "eps0"])
def test_skip_never_drops_a_needed_pair(case):
    """No skipped (group, chunk) pair holds valid points with
    ``|fl(t_p - t_q)| <= eps_t``; and the skip is not empty."""
    rng = np.random.default_rng(len(case))
    T, M = 12, 45                       # M % 8 != 0: partial last chunk
    t, ok, eps = _times(case, rng, T, M)
    tt, okt = torch.from_numpy(t), torch.from_numpy(ok)
    lo, hi = chunk_time_bounds(tt, okt, CH)
    glo, ghi = chunk_time_bounds(tt, okt, tops.PANEL_GROUP)
    skip = panel_skip_ref(glo[:, None], ghi[:, None], lo[None], hi[None],
                          eps)                     # [T, T, G, K]
    # every valid point pair, float32 difference as the kernels round it
    dt = np.abs(t[:, None, :, None] - t[None, :, None, :])
    need = (dt <= np.float32(eps)) & ok[:, None, :, None] \
        & ok[None, :, None, :]                     # [T, C, M, Mc]
    g = np.arange(M) // tops.PANEL_GROUP
    k = np.arange(M) // CH
    dropped = skip.numpy()[:, :, g[:, None], k[None, :]] & need
    assert not dropped.any(), np.argwhere(dropped)[:5]
    assert need.any()
    assert 0 < int(skip.sum()) < skip.numel()


def test_skip_nan_and_empty_bounds():
    """An empty group or chunk (+inf, -inf) always skips; a NaN bound
    never does (every comparison with it is false)."""
    inf, nan = float("inf"), float("nan")
    g_lo = torch.tensor([[0.0, nan, inf]])
    g_hi = torch.tensor([[10.0, nan, -inf]])
    c_lo = torch.tensor([[100.0, nan, inf]])
    c_hi = torch.tensor([[200.0, 5.0, -inf]])
    s = panel_skip_ref(g_lo, g_hi, c_lo, c_hi, 60.0)[0]
    assert s.tolist() == [[True, False, True], [False, False, True],
                          [True, True, True]]


def _pieces(seed=2, n=9, M=30, ms=3):
    rng = np.random.default_rng(seed)
    tb = _port(jsyn.ais_like(n_vessels=n, max_points=M, seed=seed)[0])
    sub = torch.from_numpy(rng.integers(-1, ms, (n, M)).astype(np.int32))
    return tb, sub, ms


@pytest.mark.parametrize("p0,panel,index", [(0, 5, False), (4, 9, False),
                                             (21, 6, False), (4, 9, True)])
def test_sweep_equals_wrapper_and_counts_mirror(p0, panel, index):
    """The prepared panel pass equals the public wrapper and the plain K4
    ``raw`` bit for bit; the mirror counts the (group, chunk) pairs of the
    (row, candidate) pairs it names (K7: the panel's rows against every
    candidate and every row against its candidates; K13: the planned ones
    of those).  ``stats`` counts a kernel's work: the plain version on
    the CPU refuses it."""
    tb, sub, ms = _pieces()
    eps = (15.0, 120.0, 0.0)
    plan = None
    if index:
        plan = tops.plan_fused_tiles(*(tb.x, tb.y, tb.t, tb.valid) * 2,
                                     *eps[:2])
    sweep = tops.sim_panel_sweep(tb, tb, sub, sub, ms, *eps, tile_ids=plan)
    raw = tops.stjoin_sim_fused(tb, tb, sub, sub, ms, *eps)
    fwd, rev = sweep(p0, panel=panel)
    wf, wr = tops.stjoin_sim_panel_fused(tb, tb, sub, sub, ms, *eps, p0=p0,
                                         panel=panel, tile_ids=plan)
    assert torch.equal(fwd, wf) and torch.equal(rev, wr)
    assert torch.equal(fwd, raw[p0:p0 + panel])
    assert torch.equal(rev, raw.T[p0:p0 + panel])
    pairs = sweep.pairs(p0, panel=panel)
    T, M = tb.x.shape
    t_lo, t_hi = p0 // ms, (p0 + panel - 1) // ms
    dense = {(t, c) for t in range(t_lo, t_hi + 1) for c in range(T)} \
        | {(t, c) for t in range(T) for c in range(t_lo, t_hi + 1)}
    got = [tuple(p) for p in pairs.tolist()]
    if index:
        assert set(got) <= dense
    else:
        assert len(got) == (t_hi - t_lo + 1) * T * 2 and set(got) == dense
    want = panel_skip_counts_ref(tb.t.reshape(-1), tb.valid.reshape(-1), M,
                                 sweep.chunk_lo, sweep.chunk_hi, eps[1],
                                 pairs, group=tops.PANEL_GROUP)
    assert list(want) == list(sweep.skip_counts(p0, panel=panel))
    assert want[0] == len(got) * -(-M // 8) * -(-M // CH) and want[1] > 0
    with pytest.raises(ValueError, match="outside"):
        sweep(T * ms - 1, panel=2)
    with pytest.raises(ValueError, match="stats"):
        sweep(p0, panel=panel, stats=torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("offset", [0.0, 1.7e9])
def test_panel_pass_matches_reference_adversarial_times(offset):
    """The port's panel pass against the JAX package's on a cross join
    whose times sit near the f32 grid (epoch-sized offsets: spacing 128 s)
    with eps_t close to the sampling interval."""
    rng = np.random.default_rng(7)
    jb = jsyn.ais_like(n_vessels=6, max_points=24, seed=5)[0]
    jc = jsyn.ais_like(n_vessels=7, max_points=24, seed=6)[0]
    if offset:
        jb = jb.__class__(**{f: getattr(jb, f) for f in BATCH[:2]},
                          t=(np.asarray(jb.t, np.float64) + offset
                             ).astype(np.float32),
                          **{f: getattr(jb, f) for f in BATCH[3:]})
        jc = jc.__class__(**{f: getattr(jc, f) for f in BATCH[:2]},
                          t=(np.asarray(jc.t, np.float64) + offset
                             ).astype(np.float32),
                          **{f: getattr(jc, f) for f in BATCH[3:]})
    tb, tc = _port(jb), _port(jc)
    ms = 3
    rsub = rng.integers(-1, ms, (6, 24)).astype(np.int32)
    csub = rng.integers(-1, ms, (7, 24)).astype(np.int32)
    eps = (20.0, 130.0, 0.0)
    for p0, panel in ((0, 4), (7, 8)):
        got = tops.stjoin_sim_panel_fused(
            tb, tc, torch.from_numpy(rsub), torch.from_numpy(csub), ms,
            *eps, p0=p0, panel=panel)
        want = jops.stjoin_sim_panel_fused(jb, jc, rsub, csub, ms, *eps,
                                           p0=p0, panel=panel, rows=2, bc=4,
                                           bm=8)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=ATOL)
        assert bool((got[0] > 0).any() or (got[1] > 0).any())
