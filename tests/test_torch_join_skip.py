"""PyTorch port: the time-window skip of the materialize join K1 and its
pruned twin K10.

K1 and K10 run the sweep of the fused passes on blocks of 64 consecutive
*flattened* reference points: a group of 8 points may straddle two rows
(here M = 21), and its time bounds are its own valid times.  The plain
mirror of their ``stats`` (``ops.join_skip_counts``) is held against
brute force on adversarial times, over every (group, candidate) pair or
over the (block, tile) pairs a join plan keeps: the counts are equal, and
no skipped (group, chunk) pair holds a point pair with ``|fl(t_p - t_q)|
<= eps_t``.  P = 840 is no multiple of 64, M and Mc no multiple of 8, C =
70 fills three tiles of 32.  K1's and K10's plain versions equal the JAX
package's Pallas joins (interpret mode) at epoch-sized times, to the one
ulp of ``PALLAS_K1_ATOL``; the plain versions refuse ``stats``, and K10
refuses a plan whose rows are not ascending and unique.
"""
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.kernels.stjoin import ops as jops
from repro_torch.core.types import TrajectoryBatch
from repro_torch.kernels.stjoin import ops as tops

torch.set_num_threads(1)

BATCH = ("x", "y", "t", "valid", "traj_id")
EPS_SP = 5.0
T, M, C, MC = 40, 21, 70, 19
# XLA's CPU compiler contracts the interpreted Pallas join's dx*dx + dy*dy
# into an FMA: one ulp of 1.0 in a weight, twice that stated (as in
# tests/test_torch_join.py); best_idx stays equal
PALLAS_K1_ATOL = 2.4e-7
# the port's join geometry and the JAX package's default one
JAX_JOIN = dict(bp=256, bc=8)


def _times(case, rng, R, N, nan=False):
    """``(t [R, N] f32, ok [R, N], eps_t)`` of one adversarial case
    (``nan``: one valid point's time is NaN)."""
    ok = rng.uniform(size=(R, N)) < 0.85
    eps = 60.0
    if case == "epoch":
        # near 1.7e9 the float32 spacing is 128 s: dt is 0 or >= 128
        t = (1.7e9 + np.cumsum(rng.uniform(0, 200, (R, N)), 1)).astype(
            np.float32)
        eps = 130.0
    elif case == "grid60":
        # times on a grid of eps_t: many pairs exactly +-eps_t apart
        t = (rng.integers(0, 40, (R, N)) * eps).astype(np.float32)
        t.sort(axis=1)
    elif case == "unsorted":
        t = rng.uniform(0, 3000, (R, N)).astype(np.float32)
    elif case == "padding":
        t = np.sort(rng.uniform(0, 3000, (R, N)), 1).astype(np.float32)
        ok[::3] = False                            # all-padding rows
    else:
        raise ValueError(case)
    if nan:
        t[1, 2] = np.nan
        ok[1, 2] = True
    return t, ok, eps


def _batch(rng, R, N, t, ok):
    """Rows on spatial clusters of 24 trajectories, 100 apart, so that the
    join plan keeps only some (block, tile) pairs."""
    base = (np.arange(R) // 24 * 100.0)[:, None]
    x = (base + rng.uniform(0, 10, (R, N))).astype(np.float32)
    y = rng.uniform(0, 10, (R, N)).astype(np.float32)
    return TrajectoryBatch.from_arrays(x, y, t, ok,
                                       np.arange(R, dtype=np.int32),
                                       device="cpu")


def _case(case, nan=False):
    rng = np.random.default_rng(len(case) + 7)
    t, ok, eps = _times(case, rng, T, M, nan)
    tc, okc, _ = _times(case, rng, C, MC, nan)
    return _batch(rng, T, M, t, ok), _batch(rng, C, MC, tc, okc), eps


def _plan(ref, cand, eps_t):
    mask, counts, _ = tops.plan_join_index(ref, cand, EPS_SP, eps_t)
    return tops._compact(mask, counts, None, "pruned join")


def _bounds(t, ok, size):
    """Per row, per run of ``size`` points: (min, max) of the valid,
    non-NaN times, (+inf, -inf) where there is none; by loops."""
    R, N = t.shape
    n = -(-N // size)
    lo = np.full((R, n), np.inf, np.float32)
    hi = np.full((R, n), -np.inf, np.float32)
    for r in range(R):
        for k in range(n):
            v = t[r, k * size:(k + 1) * size]
            v = v[ok[r, k * size:(k + 1) * size] & ~np.isnan(v)]
            if v.size:
                lo[r, k], hi[r, k] = v.min(), v.max()
    return lo, hi


def _flat(ref, cand):
    return tops._flat_operands(*(getattr(ref, f) for f in BATCH),
                               *(getattr(cand, f) for f in BATCH))


@pytest.mark.parametrize("index", [False, True])
@pytest.mark.parametrize("case", ["epoch", "grid60", "unsorted", "padding"])
def test_join_skip_counts_brute_force(case, index):
    """``join_skip_counts`` equals a brute-force count over the flattened
    groups of 8 points against every candidate (with the index: those of
    the plan's kept (block of 64 points, tile of 32 candidates) pairs),
    and no skipped pair holds valid points with ``|fl(t_p - t_q)| <=
    eps_t``.  Without the index one valid time is NaN (its bounds drop
    it)."""
    ref, cand, eps = _case(case, nan=not index)
    plan = _plan(ref, cand, eps) if index else None
    rt, rok = ref.t.numpy().reshape(1, -1), ref.valid.numpy().reshape(1, -1)
    ct, cok = cand.t.numpy(), cand.valid.numpy()
    g_lo, g_hi = (b[0] for b in _bounds(rt, rok, tops.PANEL_GROUP))
    c_lo, c_hi = _bounds(ct, cok, tops.PANEL_CHUNK)
    G, nch = g_lo.shape[0], c_lo.shape[1]
    assert T * M % 64 and G == -(-T * M // 8)
    pair = np.ones((G, C), bool)               # the (group, candidate) pairs
    if index:
        ids = plan.numpy()
        tiles = -(-C // 32)
        kept = np.zeros((ids.shape[0], tiles), bool)
        for b, row in enumerate(ids):
            kept[b, row[row >= 0]] = True
        assert 0 < kept.sum() < kept.size
        pair = kept[np.arange(G) // 8][:, np.arange(C) // 32]
    e = np.float32(eps)
    gl, gh = g_lo[:, None, None], g_hi[:, None, None]
    cl, ch = c_lo[None], c_hi[None]
    with np.errstate(invalid="ignore"):
        skip = (gl > gh) | (cl > ch) | ((cl - gh) > e) | ((gl - ch) > e)
    want = (int(pair.sum()) * nch, int((skip & pair[:, :, None]).sum()))
    assert tops.join_skip_counts(ref.t, ref.valid, cand.t, cand.valid, eps,
                                 tile_ids=plan) == want
    assert 0 < want[1] < want[0]
    # every valid point pair, float32 difference as the kernels round it,
    # against the skip of its (group, chunk) pair
    pts = np.arange(T * M)
    with np.errstate(invalid="ignore"):
        need = (np.abs(rt[0][:, None, None] - ct[None]) <= e) \
            & rok[0][:, None, None] & cok[None]
    dropped = skip[pts // 8][:, :, np.arange(MC) // 8] & need \
        & pair[pts // 8][:, :, None]
    assert not dropped.any(), np.argwhere(dropped)[:5]
    assert need.any()


def _epoch(jb, offset):
    return jb.__class__(**{f: getattr(jb, f) for f in BATCH[:2]},
                        t=(np.asarray(jb.t, np.float64) + offset
                           ).astype(np.float32),
                        **{f: getattr(jb, f) for f in BATCH[3:]})


def _port(jb):
    return TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in BATCH), device="cpu")


@pytest.mark.parametrize("index", [False, True])
def test_join_matches_reference_at_epoch(index):
    """K1's (K10's with the index) plain version against the JAX
    package's Pallas join (``stjoin_pallas`` / ``stjoin_pallas_pruned``)
    on a cross join whose times sit on the float32 grid of epoch-sized
    values, eps_t close to the sampling interval: ``best_idx`` equal,
    ``best_w`` to one ulp; the pruned join bitwise the dense one."""
    jb = _epoch(jsyn.ais_like(n_vessels=6, max_points=24, seed=5)[0], 1.7e9)
    jc = _epoch(jsyn.ais_like(n_vessels=35, max_points=20, seed=6)[0],
                1.7e9)
    eps = (20.0, 130.0)
    tb, tc = _port(jb), _port(jc)
    dense = tops.best_match_join_kernel(tb, tc, *eps)
    if index:
        t = tops.best_match_join_pruned(tb, tc, *eps)
        assert torch.equal(t.best_w, dense.best_w)
        assert torch.equal(t.best_idx, dense.best_idx)
        j = jops.best_match_join_pruned(jb, jc, *eps, **JAX_JOIN)
    else:
        t = dense
        j = jops.best_match_join_kernel(jb, jc, *eps)
    assert np.array_equal(np.asarray(j.best_idx), t.best_idx.numpy())
    np.testing.assert_allclose(t.best_w.numpy(), np.asarray(j.best_w),
                               rtol=0, atol=PALLAS_K1_ATOL)
    assert bool((t.best_idx >= 0).any())


@pytest.mark.parametrize("kernel", ["K1", "K10"])
def test_cpu_wrappers_refuse_stats(kernel):
    """``stats`` counts a kernel's work: K1's and K10's plain versions on
    the CPU refuse it (``ValueError``)."""
    ref, cand, eps = _case("epoch")
    ops = _flat(ref, cand)
    stats = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="stats"):
        if kernel == "K1":
            tops.stjoin_best_match(*ops[0], *ops[1], EPS_SP, eps,
                                   stats=stats)
        else:
            tops.stjoin_best_match_pruned(*ops[0], *ops[1],
                                          _plan(ref, cand, eps), EPS_SP, eps,
                                          stats=stats)


@pytest.mark.parametrize("fault", ["unsorted", "duplicate", "gap"])
def test_k10_refuses_unordered_plan(fault):
    """K10 walks each row of its plan in order, so ``stjoin_best_match_
    pruned`` refuses (``ValueError``) a row whose ids are not ascending and
    unique, or that lists an id after a -1, on the CPU as on the card; the
    plan as built passes, bitwise K1."""
    ref, cand, eps = _case("padding")
    ops = _flat(ref, cand)
    plan = _plan(ref, cand, eps)
    w, i = tops.stjoin_best_match_pruned(*ops[0], *ops[1], plan, EPS_SP, eps)
    dw, di = tops.stjoin_best_match(*ops[0], *ops[1], EPS_SP, eps)
    assert torch.equal(w, dw) and torch.equal(i, di)
    row = int(torch.nonzero((plan >= 0).sum(1) >= 2)[0, 0])
    bad = plan.clone()
    if fault == "unsorted":
        bad[row, :2] = bad[row, :2].flip(0)
    elif fault == "duplicate":
        bad[row, 1] = bad[row, 0]
    else:
        bad[row, 0] = -1
    with pytest.raises(ValueError, match="ascending"):
        tops.stjoin_best_match_pruned(*ops[0], *ops[1], bad, EPS_SP, eps)
