"""PyTorch port: the time-window skip of the dense fused passes K2 / K4
and their pruned twins K11 / K12.

The kernels skip a (group of 8 consecutive reference points, chunk of 8
candidate points) pair only when their time bounds are farther apart than
eps_t, over the (row, candidate) pairs a launch sweeps
(``ops.fused_pairs``: every pair, or a plan's kept ones).  The plain
mirror of their ``stats`` (``ops.fused_skip_counts``) is held here against
brute force on adversarial times: the counts are equal, and no skipped pair
holds a point pair with ``|fl(t_p - t_q)| <= eps_t`` (float32, the pair
test's own subtraction).  The port's fused passes equal the JAX package's
at epoch-sized times, and the plain versions on the CPU refuse ``stats``.
Exact comparisons throughout, except against the JAX package (1e-5
absolute: ROADMAP queue 3, the cell sums' order).
"""
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.kernels.stjoin import ops as jops
from repro_torch.core.types import TrajectoryBatch
from repro_torch.kernels.stjoin import ops as tops

torch.set_num_threads(1)

ATOL = 1e-5
BATCH = ("x", "y", "t", "valid", "traj_id")
EPS_SP = 5.0
# T, M, C, Mc: M and Mc not multiples of 8 (partial last group and chunk);
# C = 70 candidates in three tiles of 32
T, M, C, MC = 40, 21, 70, 19


def _times(case, rng, R, N, nan=False):
    """``(t [R, N] f32, ok [R, N], eps_t)`` of one adversarial case
    (``nan``: one valid point's time is NaN; the index takes none)."""
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
    index's plans keep only some candidate tiles."""
    base = (np.arange(R) // 24 * 100.0)[:, None]
    x = (base + rng.uniform(0, 10, (R, N))).astype(np.float32)
    y = rng.uniform(0, 10, (R, N)).astype(np.float32)
    return TrajectoryBatch.from_arrays(x, y, t, ok,
                                       np.arange(R, dtype=np.int32),
                                       device="cpu")


def _case(case, nan=False):
    rng = np.random.default_rng(len(case))
    t, ok, eps = _times(case, rng, T, M, nan)
    tc, okc, _ = _times(case, rng, C, MC, nan)
    return _batch(rng, T, M, t, ok), _batch(rng, C, MC, tc, okc), eps


def _plan(ref, cand, eps_t):
    return tops.plan_fused_tiles(ref.x, ref.y, ref.t, ref.valid, cand.x,
                                 cand.y, cand.t, cand.valid, EPS_SP, eps_t)


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


@pytest.mark.parametrize("index", [False, True])
def test_fused_pairs(index):
    """The (row, candidate) pairs of a launch: every pair, or each row
    against the candidates (below C) of its planned tiles."""
    ref, cand, eps = _case("padding", nan=not index)
    if not index:
        got = tops.fused_pairs(T, C).tolist()
        assert got == [[t, c] for t in range(T) for c in range(C)]
        return
    plan = _plan(ref, cand, eps)
    ids = plan.tile_ids.numpy()
    want = [[t, c] for t in range(T) for j in ids[t] if j >= 0
            for c in range(32 * j, min(32 * j + 32, C))]
    assert 0 < len(want) < T * C                   # the plan skips tiles
    assert tops.fused_pairs(T, C, plan).tolist() == want


@pytest.mark.parametrize("index", [False, True])
@pytest.mark.parametrize("case", ["epoch", "grid60", "unsorted", "padding"])
def test_skip_counts_brute_force(case, index):
    """``fused_skip_counts`` equals a brute-force count of the (group,
    chunk) pairs tested and skipped over the launch's pairs, and no
    skipped pair holds valid points with ``|fl(t_p - t_q)| <= eps_t``.
    Without the index one valid time is NaN (its bounds drop it)."""
    ref, cand, eps = _case(case, nan=not index)
    plan = _plan(ref, cand, eps) if index else None
    pairs = tops.fused_pairs(T, C, plan).numpy()
    rt, rok = ref.t.numpy(), ref.valid.numpy()
    ct, cok = cand.t.numpy(), cand.valid.numpy()
    g_lo, g_hi = _bounds(rt, rok, tops.PANEL_GROUP)
    c_lo, c_hi = _bounds(ct, cok, tops.PANEL_CHUNK)
    e = np.float32(eps)
    t, c = pairs[:, 0], pairs[:, 1]
    gl, gh = g_lo[t][:, :, None], g_hi[t][:, :, None]
    cl, ch = c_lo[c][:, None, :], c_hi[c][:, None, :]
    with np.errstate(invalid="ignore"):
        skip = (gl > gh) | (cl > ch) | ((cl - gh) > e) | ((gl - ch) > e)
    want = (skip.size, int(skip.sum()))
    assert tops.fused_skip_counts(ref.t, ref.valid, cand.t, cand.valid,
                                  eps, tile_ids=plan) == want
    assert 0 < want[1] < want[0]
    # every valid point pair of the launch, float32 difference as the
    # kernels round it, against the skip of its (group, chunk) pair
    with np.errstate(invalid="ignore"):
        need = (np.abs(rt[t][:, :, None] - ct[c][:, None, :]) <= e) \
            & rok[t][:, :, None] & cok[c][:, None, :]
    g = np.arange(M) // tops.PANEL_GROUP
    k = np.arange(MC) // tops.PANEL_CHUNK
    dropped = skip[:, g[:, None], k[None, :]] & need
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


def _reference_pair(offset=1.7e9):
    """A cross join whose times sit on the float32 grid of epoch-sized
    values (spacing 128 s), with eps_t close to the sampling interval."""
    jb = _epoch(jsyn.ais_like(n_vessels=6, max_points=24, seed=5)[0], offset)
    jc = _epoch(jsyn.ais_like(n_vessels=35, max_points=20, seed=6)[0],
                offset)
    return jb, jc, (20.0, 130.0, 200.0)


@pytest.mark.parametrize("index", [False, True])
def test_vote_pass_matches_reference_at_epoch(index):
    """K2's (K11's with the index) plain version against the JAX
    package's pass 1: words equal, vote to 1e-5; the pruned pass bitwise
    the dense one."""
    jb, jc, eps = _reference_pair()
    tb, tc = _port(jb), _port(jc)
    args = (*(getattr(tb, f) for f in BATCH), *(getattr(tc, f)
                                                for f in BATCH), *eps)
    v, w = tops.stjoin_vote_fused_arrays(*args)
    if index:
        plan = tops.plan_fused_tiles(tb.x, tb.y, tb.t, tb.valid, tc.x, tc.y,
                                     tc.t, tc.valid, *eps[:2])
        pv, pw = tops.stjoin_vote_fused_arrays(*args, tile_ids=plan)
        assert torch.equal(pv, v) and torch.equal(pw, w)
    jv, jw = jops.stjoin_vote_fused_arrays(
        *(getattr(jb, f) for f in BATCH), *(getattr(jc, f) for f in BATCH),
        *eps)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    assert np.array_equal(w.numpy().view(np.uint32), np.asarray(jw))
    assert bool((w != 0).any())


@pytest.mark.parametrize("index", [False, True])
def test_sim_pass_matches_reference_at_epoch(index):
    """K4's (K12's with the index) plain version against the JAX
    package's pass 2 to 1e-5; the pruned pass bitwise the dense one."""
    jb, jc, eps = _reference_pair()
    tb, tc = _port(jb), _port(jc)
    rng = np.random.default_rng(3)
    ms = 3
    rsub = rng.integers(-1, ms, tb.x.shape).astype(np.int32)
    csub = rng.integers(-1, ms, tc.x.shape).astype(np.int32)
    args = (tb, tc, torch.from_numpy(rsub), torch.from_numpy(csub), ms,
            *eps)
    raw = tops.stjoin_sim_fused(*args)
    if index:
        plan = tops.plan_fused_tiles(tb.x, tb.y, tb.t, tb.valid, tc.x, tc.y,
                                     tc.t, tc.valid, *eps[:2])
        assert torch.equal(tops.stjoin_sim_fused(*args, tile_ids=plan), raw)
    want = jops.stjoin_sim_fused(jb, jc, rsub, csub, ms, *eps)
    np.testing.assert_allclose(raw.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert bool((raw > 0).any())


@pytest.mark.parametrize("index", [False, True])
@pytest.mark.parametrize("which", ["vote", "sim"])
def test_cpu_wrappers_refuse_stats(which, index):
    """``stats`` counts a kernel's work: the plain versions on the CPU
    refuse it (``ValueError``), with or without a plan."""
    ref, cand, eps = _case("epoch")
    plan = _plan(ref, cand, eps) if index else None
    stats = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="stats"):
        if which == "vote":
            tops.stjoin_vote_fused(ref, cand, EPS_SP, eps, stats=stats,
                                   use_index=index)
        else:
            sub = torch.zeros(ref.x.shape, dtype=torch.int32)
            csub = torch.zeros(cand.x.shape, dtype=torch.int32)
            tops.stjoin_sim_fused(ref, cand, sub, csub, 2, EPS_SP, eps,
                                  tile_ids=plan, stats=stats)
