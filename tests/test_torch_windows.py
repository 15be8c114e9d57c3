"""PyTorch port: the sliding-window engine, bit packing and voting held
against the JAX package.  Packed words travel as int32 bit patterns in the
port and as uint32 in the reference; they compare equal as uint32."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import windows as jwin
from repro_torch.core import windows as twin

torch.set_num_threads(1)


def _words_u32(w):
    return np.asarray(w).astype(np.uint32)


def _words_i32(w):
    return torch.from_numpy(np.asarray(w, np.uint32).view(np.int32).copy())


@pytest.mark.parametrize("lo,hi", [(-3, -1), (0, 2), (-2, 2), (1, 4),
                                   (-5, -5), (3, 1), (-40, 40)])
@pytest.mark.parametrize("op", ["sum", "max", "or"])
def test_sliding_reduce(op, lo, hi):
    rng = np.random.default_rng(abs(lo) * 7 + hi)
    if op == "or":
        x = rng.integers(0, 2**32, (3, 17, 2), dtype=np.uint32)
        j = jwin.sliding_reduce(jnp.asarray(x), lo, hi, op)
        t = twin.sliding_reduce(_words_i32(x), lo, hi, op)
        assert np.array_equal(_words_u32(j), t.numpy().view(np.uint32))
        return
    if op == "max":
        x = rng.normal(size=(3, 17)).astype(np.float32)
    else:   # integer-valued floats keep the prefix sums exact
        x = rng.integers(0, 9, (3, 17)).astype(np.float32)
    j = np.asarray(jwin.sliding_reduce(jnp.asarray(x), lo, hi, op))
    t = twin.sliding_reduce(torch.from_numpy(x), lo, hi, op).numpy()
    assert np.array_equal(j, t)


@pytest.mark.parametrize("C", [1, 31, 32, 33, 70, 96])
def test_pack_unpack(C):
    rng = np.random.default_rng(C)
    bits = rng.uniform(size=(4, 6, C)) < 0.5
    j = _words_u32(jwin.pack_bits(jnp.asarray(bits)))
    t = twin.pack_bits(torch.from_numpy(bits))
    assert t.dtype == torch.int32
    assert np.array_equal(j, t.numpy().view(np.uint32))
    assert np.array_equal(
        twin.pack_bits(torch.from_numpy(bits), rows_per_chunk=1).numpy(),
        t.numpy())
    assert np.array_equal(twin.unpack_bits(t, C).numpy(), bits)


def test_popcount32():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    want = np.array([bin(int(v)).count("1") for v in x])
    assert np.array_equal(twin.popcount32(_words_i32(x)).numpy(), want)


def test_voting_matches_reference():
    """Eqs. 4-6 and the packed TSA2 words from one join cube."""
    from repro.core import voting as jvot
    from repro.core.types import JoinResult as JJoin
    from repro_torch.core import voting as tvot
    from repro_torch.core.types import JoinResult
    rng = np.random.default_rng(11)
    w = (rng.uniform(size=(5, 9, 37)) * (rng.uniform(size=(5, 9, 37)) < 0.4)
         ).astype(np.float32)
    idx = np.where(w > 0, rng.integers(0, 9, w.shape), -1).astype(np.int32)
    valid = rng.uniform(size=(5, 9)) < 0.8
    jj = JJoin(best_w=jnp.asarray(w), best_idx=jnp.asarray(idx))
    tj = JoinResult(best_w=torch.from_numpy(w), best_idx=torch.from_numpy(idx))
    jv = jvot.point_voting(jj)
    tv = tvot.point_voting(tj)
    # 37-term float32 sums in another order: a few ulps of values below 37
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    vote = np.array(jv)
    for fn in ("normalized_voting", "trajectory_voting"):
        a = np.asarray(getattr(jvot, fn)(jnp.asarray(vote), jnp.asarray(valid)))
        b = getattr(tvot, fn)(torch.from_numpy(vote), torch.from_numpy(valid))
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=0)
    assert np.array_equal(_words_u32(jvot.neighbor_mask_packed(jj)),
                          tvot.neighbor_mask_packed(tj).numpy().view(np.uint32))
