"""PyTorch port: the plain mirror of K14's warp-strip schedule and its exact
time test, held against the contract.

``lcss_strip_ref`` walks the LCSS DP as the CUDA kernel does (one warp a
pair, ``strip_rows(N)`` rows a lane, columns skewed one step a lane, the
bottom row of a strip carried to the next, a cell that does not match
taking the larger of its two neighbours alone) with its weights from
``strip_weights``, which rejects a cell before its distance is formed
when a point is invalid or when ``dt > eps_t``.  On seeded numpy inputs it
must give, bit for bit:

* the port's row scan ``lcss_ref`` and sheared wavefront
  ``lcss_wavefront_ref``;
* the JAX package's Pallas sweep ``lcss_pallas`` (interpret mode) over the
  port's sheared weights: the same maxima and adds in the same order;
* itself on the swapped pairs.

Against the JAX package's own weights (``lcss_scores``) the count channel
is equal and the weighted channel within 1e-5, the tolerance of
``tests/test_torch_lcss.py`` (XLA may contract ``dx*dx + dy*dy`` into an
FMA).  The adversarial cases put values on the tests' edges: ``|dx|``
one ulp either side of ``eps_sp``, ``dt == eps_t`` and one ulp above, NaN
and infinite coordinates, a subnormal ``eps_sp``; there the weights must
equal ``match_weights`` cell by cell.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.lcss import lcss as jlcss
from repro.kernels.lcss import ops as jops
from repro_torch.kernels.lcss import ref as tref

torch.set_num_threads(1)
ATOL = 1e-5
EPS = (2.0, 25.0)


def _pairs(B, N, M, seed, p_valid=0.9):
    """Points in a 5 x 5 box, sorted times in [0, 50), about 10%
    invalid (``tests/test_kernels.py``'s LCSS inputs)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    out = []
    for n in (N, M):
        out += [rng.uniform(0, 5, (B, n)).astype(f),
                rng.uniform(0, 5, (B, n)).astype(f),
                np.sort(rng.uniform(0, 50, (B, n)), 1).astype(f),
                rng.uniform(0, 1, (B, n)) < p_valid]
    return out


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_bitwise_all(arrays, eps_sp, eps_t):
    """The mirror against the port's plain DPs, the Pallas sweep over the
    port's sheared weights and the swapped pairs; returns its scores."""
    t = _torch(arrays)
    got = tref.lcss_strip_ref(*t, eps_sp, eps_t)
    ws = tref.shear_weights(*t, eps_sp, eps_t)
    assert torch.equal(got, tref.lcss_ref(*t, eps_sp, eps_t))
    assert torch.equal(got, tref.lcss_wavefront_ref(ws))
    pallas = np.asarray(jlcss.lcss_pallas(jnp.asarray(ws.numpy()),
                                          interpret=True))
    assert np.array_equal(got.numpy(), pallas)
    assert torch.equal(got, tref.lcss_strip_ref(*t[4:], *t[:4], eps_sp,
                                                eps_t))
    return got


# N != M over {1, 31, 33, 128, 200}, each on both sides, one and two
# strips (N = 200 > 128), and the full-width shape 128 x 128
SHAPES = [(1, 31), (31, 1), (33, 128), (128, 33), (128, 200), (200, 128),
          (1, 200), (200, 33), (31, 128), (128, 128)]


@pytest.mark.parametrize("N,M", SHAPES)
def test_strip_mirror_matches(N, M):
    arrays = _pairs(3, N, M, 7 * N + M)
    got = _assert_bitwise_all(arrays, *EPS)
    want = np.asarray(jops.lcss_scores(*arrays, *EPS, interpret=True))
    np.testing.assert_array_equal(got[:, 1].numpy(), want[:, 1])
    np.testing.assert_allclose(got[:, 0].numpy(), want[:, 0], rtol=0,
                               atol=ATOL)
    assert bool((got[:, 1] > 0).any())


def _edge_pairs(case):
    """Five reference points against five candidate points, all at x = y =
    0 and 100 apart in time, so that only the cells (i, i) can match;
    each case moves the candidate points onto an edge of the match tests
    or past it.  (arrays, eps_sp, eps_t)."""
    f = np.float32
    eps_sp, eps_t = f(2.0), f(25.0)
    up = np.nextafter(eps_sp, f(np.inf))
    down = np.nextafter(eps_sp, f(0))
    rx = np.zeros((1, 5), f)
    ry = np.zeros_like(rx)
    rt = np.arange(5, dtype=f)[None] * f(100)
    sx, sy, st = rx.copy(), ry.copy(), rt.copy()
    if case == "dx_ulp_above":
        sx[0] = up
        sx[0, 2] = -up
    elif case == "dx_ulp_below":
        sx[0] = down
        sx[0, 2] = -down
    elif case == "dy_ulp_either_side":
        sy[0, ::2] = up
        sy[0, 1::2] = -down
    elif case == "dt_equals_eps_t":
        st = rt + eps_t
        st[0, 1] = np.nextafter(st[0, 1], f(np.inf))
    elif case == "nan":
        sx[0, 1] = np.nan
        st[0, 3] = np.nan
        ry[0, 2] = np.nan
    elif case == "inf":
        sx[0, 1] = np.inf
        rx[0, 1] = np.inf
        sy[0, 3] = -np.inf
        st[0, 4] = np.inf
    elif case == "subnormal_eps":
        # |dx| = 1e-30 > eps_sp, but dx * dx underflows to 0, so d = 0 <=
        # eps_sp: matches
        eps_sp = f(1e-40)
        sx[0] = f(1e-30)
    elif case == "tiny_eps":
        eps_sp = f(2.0 ** -63)
        sx[0] = np.nextafter(eps_sp, f(np.inf))
        sx[0, 1] = eps_sp
    v = np.ones_like(rx, bool)
    return [rx, ry, rt, v, sx, sy, st, v.copy()], eps_sp, eps_t


EDGES = ["dx_ulp_above", "dx_ulp_below", "dy_ulp_either_side",
         "dt_equals_eps_t", "nan", "inf", "subnormal_eps", "tiny_eps"]


@pytest.mark.parametrize("case", EDGES)
def test_prefilter_edges(case):
    """On the edges the time test rejects no cell that the plain weights
    match, the weights are the plain ones, and the mirror keeps the plain
    scores bit for bit."""
    arrays, eps_sp, eps_t = _edge_pairs(case)
    t = _torch(arrays)
    r = [a[:, :, None] for a in t[:4]]
    c = [a[:, None, :] for a in t[4:]]
    w, u, timed = tref.strip_weights(*r, *c, eps_sp, eps_t)
    want = tref.match_weights(*t, eps_sp, eps_t)
    assert torch.equal(w, want[:, 0]) and torch.equal(u, want[:, 1])
    assert bool((timed | (u < 0)).all())
    _assert_bitwise_all(arrays, eps_sp, eps_t)
    matched = int((u > 0).sum())
    assert matched == {"dx_ulp_above": 0, "dx_ulp_below": 5,
                       "dy_ulp_either_side": 2, "dt_equals_eps_t": 4,
                       "nan": 2, "inf": 2, "subnormal_eps": 5,
                       "tiny_eps": 1}[case]
    if case == "dt_equals_eps_t":
        assert int(timed.sum()) == matched      # one ulp above: rejected


def test_time_prefilter_random():
    """1e6 random cells of magnitudes 2^-60 .. 2^60 at several eps: the
    weights behind the time test equal the plain ones bit for bit."""
    rng = np.random.default_rng(20)
    n = 1_000_000
    f = np.float32
    scale = 2.0 ** rng.integers(-60, 60, n)
    cols = [(rng.uniform(-1, 1, n) * scale).astype(f) for _ in range(6)]
    for eps_sp, eps_t in ((f(1.0), f(1.0)), (f(3e-9), f(7e12)),
                          (f(7e12), f(3e-9))):
        rx, ry, rt, sx, sy, st = (torch.from_numpy(a)[:, None]
                                  for a in cols)
        v = torch.ones((n, 1), dtype=torch.bool)
        w, u, _ = tref.strip_weights(rx, ry, rt, v, sx, sy, st, v, eps_sp,
                                     eps_t)
        want = tref.match_weights(rx, ry, rt, v, sx, sy, st, v, eps_sp,
                                  eps_t)                   # [n, 2, 1, 1]
        assert torch.equal(w, want[:, 0, 0])
        assert torch.equal(u, want[:, 1, 0])
        assert bool((u > 0).any()) and bool((u < 0).any())


def test_prefilter_counts():
    """The counts chip_smoke.py reports nest: matched <= timed <= valid <=
    cells, matched = the plain matches; the slices add up."""
    arrays = _torch(_pairs(5, 40, 33, 9))
    n = tref.prefilter_counts(*arrays, *EPS, pairs=2)
    assert n == tref.prefilter_counts(*arrays, *EPS)
    assert n["cells"] >= n["valid"] >= n["timed"] >= n["matched"] > 0
    want = tref.match_weights(*arrays, *EPS)
    assert n["matched"] == int((want[:, 1] > 0).sum())
    assert n["valid"] == int((arrays[3][:, :, None]
                              & arrays[7][:, None, :]).sum())
