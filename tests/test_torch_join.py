"""PyTorch port: the join (Problem 1) held against the JAX package.

The plain K1 (``repro_torch.kernels.stjoin``) against the Pallas kernel in
interpret mode: ``best_idx`` equal, ``best_w`` to one ulp (see
``PALLAS_K1_ATOL``) and bitwise against the jnp oracle ``stjoin_ref``.  The plain join
of ``core.geometry`` against its own reference, with and without the
delta_t refine.  The CUDA kernel against its plain version needs a card.
"""
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core.types import TrajectoryBatch as JB
from repro.data.synthetic import ais_like, figure1_scenario
from repro.kernels.stjoin import ops as jops
from repro_torch.core import geometry as tgeo
from repro_torch.core.types import TrajectoryBatch
from repro_torch.kernels.stjoin import ops as tops
from repro_torch.kernels.stjoin.ref import stjoin_ref

torch.set_num_threads(1)

FIELDS = ("x", "y", "t", "valid", "traj_id")


def _port(jb: JB) -> TrajectoryBatch:
    return TrajectoryBatch.from_arrays(
        *(np.asarray(getattr(jb, f)) for f in FIELDS), device="cpu")


def _cases():
    fig, _ = figure1_scenario(n_per_route=2, points_per_leg=12, seed=0)
    fig_pad, _ = figure1_scenario(n_per_route=1, points_per_leg=10, seed=4,
                                  pad_trajs_to=8)
    ais, _ = ais_like(n_vessels=10, max_points=40, seed=1)
    return {"fig1": (fig, 0.42, 1.0), "fig1_pad": (fig_pad, 0.3, 1.5),
            "ais": (ais, 15.0, 120.0)}


CASES = _cases()


# XLA's CPU compiler contracts the interpreted Pallas kernel's
# ``dx*dx + dy*dy`` into a fused multiply-add; the port rounds the product
# and the sum separately (as the CUDA kernel does, with -fmad=false).  The
# two d2 differ by an ulp, and w = 1 - sqrt(d2)/eps_sp by at most one ulp
# of 1.0 (measured: 14 of 1516 weights of the fig1 case, all 5.96e-8 or
# 1.19e-7).  Twice that is the stated tolerance; best_idx stays equal.
PALLAS_K1_ATOL = 2.4e-7


def _assert_join(j, t, atol=0.0):
    assert np.array_equal(np.asarray(j.best_idx), t.best_idx.numpy())
    if atol == 0.0:
        assert np.array_equal(np.asarray(j.best_w), t.best_w.numpy())
    else:
        np.testing.assert_allclose(t.best_w.numpy(), np.asarray(j.best_w),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1_matches_pallas_kernel(case):
    jb, eps_sp, eps_t = CASES[case]
    j = jops.best_match_join_kernel(jb, jb, eps_sp, eps_t)
    t = tops.best_match_join_kernel(_port(jb), _port(jb), eps_sp, eps_t)
    assert t.best_w.dtype == torch.float32 and t.best_idx.dtype == torch.int32
    _assert_join(j, t, atol=PALLAS_K1_ATOL)
    assert (t.best_idx.numpy() >= 0).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k1_matches_jnp_oracle_bitwise(case):
    from repro.kernels.stjoin.ref import stjoin_ref as jref
    jb, eps_sp, eps_t = CASES[case]
    T, M = jb.x.shape
    ja = (jb.x.reshape(-1), jb.y.reshape(-1), jb.t.reshape(-1),
          np.repeat(np.asarray(jb.traj_id), M), jb.valid.reshape(-1),
          jb.x, jb.y, jb.t, jb.traj_id, jb.valid)
    jw, ji = jref(*ja, np.float32(eps_sp), np.float32(eps_t))
    tw, ti = stjoin_ref(*(torch.from_numpy(np.array(a)) for a in ja),
                        eps_sp, eps_t)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(np.asarray(jw), tw.numpy())


def test_plain_k1_boundary_ties():
    """Points on the cylinder's edge and duplicated candidate points: the
    first index wins, and a weight that rounds to 0 yields (0, -1)."""
    x = np.array([[0.3, 0.1, 0.2, 0.1, 0.3],
                  [0.3, 0.3, 0.5, 0.7, 0.9]], np.float32)
    y = np.zeros_like(x)
    t = np.tile(np.arange(5, dtype=np.float32), (2, 1))
    ok = np.ones_like(x, bool)
    ref = (np.zeros(1, np.float32), np.zeros(1, np.float32),
           np.full(1, 2.0, np.float32), np.full(1, 7, np.int32),
           np.ones(1, bool))
    cand = (x, y, t, np.array([3, 4], np.int32), ok)
    from repro.kernels.stjoin.ref import stjoin_ref as jref
    jw, ji = jref(*ref, *cand, np.float32(0.3), np.float32(5.0))
    tw, ti = stjoin_ref(*(torch.from_numpy(a) for a in ref + cand), 0.3, 5.0)
    assert np.array_equal(np.asarray(jw), tw.numpy())
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert ti[0].tolist() == [1, -1] and float(tw[0, 1]) == 0.0


@pytest.mark.parametrize("chunk", [1, 7, 1 << 20])
def test_plain_k1_chunking_is_exact(chunk):
    jb, eps_sp, eps_t = CASES["ais"]
    tb = _port(jb)
    T, M = tb.x.shape
    args = (tb.x.reshape(-1), tb.y.reshape(-1), tb.t.reshape(-1),
            tb.traj_id[:, None].expand(T, M).reshape(-1),
            tb.valid.reshape(-1), tb.x, tb.y, tb.t, tb.traj_id, tb.valid,
            eps_sp, eps_t)
    w0, i0 = stjoin_ref(*args)
    w1, i1 = stjoin_ref(*args, chunk_elements=chunk * tb.x.numel())
    assert torch.equal(w0, w1) and torch.equal(i0, i1)


@pytest.mark.parametrize("delta_t", [0.0, 2.5, 400.0])
@pytest.mark.parametrize("case", ["fig1", "ais"])
def test_plain_join_matches_reference(case, delta_t):
    jb, eps_sp, eps_t = CASES[case]
    j = jgeo.subtrajectory_join(jb, jb, eps_sp, eps_t, delta_t)
    t = tgeo.subtrajectory_join(_port(jb), _port(jb), eps_sp, eps_t, delta_t)
    _assert_join(j, t)


@pytest.mark.parametrize("delta_t", [0.0, 2.5, 400.0])
@pytest.mark.parametrize("case", ["fig1", "ais"])
def test_kernel_join_with_refine_matches_reference(case, delta_t):
    jb, eps_sp, eps_t = CASES[case]
    j = jops.subtrajectory_join(jb, jb, eps_sp, eps_t, delta_t)
    t = tops.subtrajectory_join(_port(jb), _port(jb), eps_sp, eps_t, delta_t)
    _assert_join(j, t, atol=PALLAS_K1_ATOL)


def test_index_join_is_a_later_slice():
    jb, eps_sp, eps_t = CASES["fig1"]
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        tops.subtrajectory_join(_port(jb), _port(jb), eps_sp, eps_t,
                                use_index=True)
