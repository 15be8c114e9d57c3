"""PyTorch port: the exact LCSS entry points held against the JAX package.

The same numpy inputs, made from a seed, go through ``repro``'s
``lcss_scores`` (the Pallas kernel in interpret mode) and ``lcss_ref``,
and through the port's plain versions on the CPU: its ``shear_weights``,
its sheared wavefront (``lcss_wavefront_ref``, the CUDA kernel's plain
twin), its row scan (``lcss_ref``) and the public ``lcss_scores`` /
``lcss_similarity(device="cpu")``.  Tolerances and why:

* the count channel (Eq. 1), the match pattern and the unit weights are
  equal;
* the weighted channel (Eq. 2) and the weights to 1e-5 absolute: XLA may
  contract ``dx*dx + dy*dy`` into an FMA, so a weight may sit an ulp
  (1.2e-7) from the port's, and a score sums up to min(N, M) of them;
* within the port, equal bit for bit: the sheared wavefront and the row
  scan (three exact maxima and one add a cell, in the same order), and a
  pair and its transpose.
"""
import numpy as np
import pytest
import torch

from repro.kernels.lcss import lcss as jlcss
from repro.kernels.lcss import ops as jops
from repro.kernels.lcss import ref as jref
from repro_torch.data.synthetic import ais_like, default_dsc_params_for
from repro_torch.kernels.lcss import ops as tops
from repro_torch.kernels.lcss import ref as tref

torch.set_num_threads(1)
ATOL = 1e-5


def _random_pairs(B, N, M, seed, p_valid=0.9):
    """``tests/test_kernels.py``'s LCSS inputs: points in a 5 x 5 box,
    sorted times in [0, 50), about 10% invalid."""
    rng = np.random.default_rng(seed)
    f = np.float32
    r = (rng.uniform(0, 5, (B, N)).astype(f), rng.uniform(0, 5, (B, N)).astype(f),
         np.sort(rng.uniform(0, 50, (B, N)), 1).astype(f),
         rng.uniform(0, 1, (B, N)) < p_valid)
    s = (rng.uniform(0, 5, (B, M)).astype(f), rng.uniform(0, 5, (B, M)).astype(f),
         np.sort(rng.uniform(0, 50, (B, M)), 1).astype(f),
         rng.uniform(0, 1, (B, M)) < p_valid)
    return r + s, 2.0, 25.0


def _ais_pairs(n=6, M=40, shift=1):
    """AIS-like vessels on 2 lanes, each paired with the row ``shift``
    after it, at the dataset's own eps (``default_dsc_params_for``)."""
    tb, _ = ais_like(n_vessels=n, max_points=M, n_lanes=2, seed=3,
                     device="cpu")
    diam, mean_dt = default_dsc_params_for(tb)
    nxt = torch.roll(torch.arange(n), -shift)
    cols = [tb.x, tb.y, tb.t, tb.valid]
    arrays = tuple(c.numpy() for c in cols) + tuple(c[nxt].numpy()
                                                     for c in cols)
    return arrays, 0.15 * diam, mean_dt


CASES = {
    "2x16x16": _random_pairs(2, 16, 16, 2 * 7 + 16),
    "3x8x24": _random_pairs(3, 8, 24, 3 * 7 + 8),
    "1x33x17": _random_pairs(1, 33, 17, 1 * 7 + 33),
    "ais": _ais_pairs(),
}


def _torch(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _swap(arrays):
    return arrays[4:] + arrays[:4]


def _jax(fn, arrays, eps_sp, eps_t, **kw):
    return np.asarray(fn(*arrays, eps_sp, eps_t, **kw))


def _assert_scores(got, want):
    """Count channel equal; weighted channel to ``ATOL``."""
    got = np.asarray(got)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shear_weights_match_jax(case):
    arrays, eps_sp, eps_t = CASES[case]
    want = _jax(jlcss.shear_weights, arrays, eps_sp, eps_t)
    got = tref.shear_weights(*_torch(arrays), eps_sp, eps_t).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_array_equal(got[:, 0] == tref.NEG,
                                  want[:, 0] == jlcss.NEG)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_dps_match_jax(case):
    """Both plain DPs against the JAX oracle and the Pallas kernel
    (interpret mode); the port's two are bitwise equal to each other."""
    arrays, eps_sp, eps_t = CASES[case]
    t = _torch(arrays)
    row = tref.lcss_ref(*t, eps_sp, eps_t)
    wave = tref.lcss_wavefront_ref(tref.shear_weights(*t, eps_sp, eps_t))
    assert torch.equal(row, wave)
    want_ref = np.maximum(_jax(jref.lcss_ref, arrays, eps_sp, eps_t), 0.0)
    want_pallas = _jax(jops.lcss_scores, arrays, eps_sp, eps_t,
                       interpret=True)
    for want in (want_ref, want_pallas):
        _assert_scores(row.numpy(), want)
    assert (row[:, 1] > 0).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_entry_points_match_jax(case):
    arrays, eps_sp, eps_t = CASES[case]
    got = tops.lcss_scores(*arrays, eps_sp, eps_t, device="cpu")
    _assert_scores(got.numpy(), _jax(jops.lcss_scores, arrays, eps_sp,
                                     eps_t, interpret=True))
    sim = tops.lcss_similarity(*arrays, eps_sp, eps_t, device="cpu")
    want = _jax(jref.lcss_similarity_ref, arrays, eps_sp, eps_t)
    np.testing.assert_array_equal(sim[:, 1].numpy(), want[:, 1])
    np.testing.assert_allclose(sim[:, 0].numpy(), want[:, 0], rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(
        tref.lcss_similarity_ref(*_torch(arrays), eps_sp, eps_t).numpy(),
        sim.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_swapped_pairs_bitwise(case):
    arrays, eps_sp, eps_t = CASES[case]
    a = tops.lcss_scores(*arrays, eps_sp, eps_t, device="cpu")
    b = tops.lcss_scores(*_swap(arrays), eps_sp, eps_t, device="cpu")
    assert torch.equal(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_score_bounds(case):
    """0 <= weighted <= count <= min(n, m)."""
    arrays, eps_sp, eps_t = CASES[case]
    s = tops.lcss_scores(*arrays, eps_sp, eps_t, device="cpu")
    n = torch.from_numpy(arrays[3]).sum(1)
    m = torch.from_numpy(arrays[7]).sum(1)
    assert bool((s[:, 0] >= 0).all()) and bool((s[:, 0] <= s[:, 1]).all())
    assert bool((s[:, 1] <= torch.minimum(n, m)).all())


def test_all_invalid_pair_scores_zero():
    """A pair with no valid point, beside a normal one: its scores and
    similarities are 0 in both packages."""
    arrays, eps_sp, eps_t = _random_pairs(2, 12, 9, 5)
    arrays = tuple(np.array(a) for a in arrays)
    arrays[3][0] = False
    arrays[7][0] = False
    got = tops.lcss_scores(*arrays, eps_sp, eps_t, device="cpu")
    want = _jax(jops.lcss_scores, arrays, eps_sp, eps_t, interpret=True)
    _assert_scores(got.numpy(), want)
    assert got[0].tolist() == [0.0, 0.0] and got[1, 1] > 0
    sim = tops.lcss_similarity(*arrays, eps_sp, eps_t, device="cpu")
    assert sim[0].tolist() == [0.0, 0.0]


def test_identical_sequences_full_score():
    rng = np.random.default_rng(0)
    N = 24
    x, y = (rng.uniform(0, 5, (1, N)).astype(np.float32) for _ in range(2))
    t = np.sort(rng.uniform(0, 50, (1, N)), 1).astype(np.float32)
    v = np.ones((1, N), bool)
    sim = tops.lcss_similarity(x, y, t, v, x, y, t, v, 2.0, 25.0,
                               device="cpu")
    assert sim[0].tolist() == [1.0, 1.0]


def test_degenerate_shapes():
    """N = 1 and M = 1 agree with JAX; empty sequences are refused."""
    for B, N, M in ((3, 1, 9), (2, 7, 1)):
        arrays, eps_sp, eps_t = _random_pairs(B, N, M, N + M)
        got = tops.lcss_scores(*arrays, eps_sp, eps_t, device="cpu")
        _assert_scores(got.numpy(), _jax(jref.lcss_ref, arrays, eps_sp,
                                         eps_t))
    arrays, eps_sp, eps_t = _random_pairs(1, 4, 4, 0)
    empty = arrays[:4] + tuple(a[:, :0] for a in arrays[4:])
    with pytest.raises(ValueError, match="empty"):
        tops.lcss_scores(*empty, eps_sp, eps_t, device="cpu")


def test_no_card_means_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arrays, eps_sp, eps_t = CASES["2x16x16"]
    for fn in (tops.lcss_scores, tops.lcss_similarity):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*arrays, eps_sp, eps_t)


@pytest.mark.parametrize("interpret", [None, True, False])
def test_interpret_is_accepted_and_ignored(interpret):
    """The reference's ``interpret`` (Pallas' interpret mode, the same
    kernel body either way) is taken and changes nothing."""
    arrays, eps_sp, eps_t = CASES[sorted(CASES)[0]]
    for fn in (tops.lcss_scores, tops.lcss_similarity):
        base = fn(*arrays, eps_sp, eps_t, device="cpu")
        got = fn(*arrays, eps_sp, eps_t, interpret=interpret, device="cpu")
        assert torch.equal(got, base)
