"""PyTorch port on the card: each CUDA kernel against its plain version.

Marked ``gpu``; every test skips without a CUDA card (the kernels have no
CPU mode).  The file imports neither JAX nor the JAX package, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import segmentation as tseg
from repro_torch.core.dsc import run_dsc
from repro_torch.core.plan import EnginePlan
from repro_torch.core.similarity import slot_ids
from repro_torch.core.types import DSCParams
from repro_torch.core.windows import pack_bits
from repro_torch.data.synthetic import ais_like, figure1_scenario
from repro_torch.kernels.cluster.ops import cluster_assign, cluster_round_scan
from repro_torch.kernels.jaccard.ops import window_jaccard
from repro_torch.kernels.stjoin import ops as stjoin_ops
from repro_torch.kernels.stjoin.ops import best_match_join_kernel
from repro_torch.kernels.stjoin.ref import (stjoin_ref, stjoin_sim_fused_ref,
                                            stjoin_vote_fused_ref)

pytestmark = pytest.mark.gpu

# the kernels each path of the kernel plan launches, and no other
PATH_KERNELS = {
    "materialize": {"stjoin_best_match", "jaccard_window", "round_scan",
                    "claim_max"},
    "fused": {"stjoin_vote_fused", "jaccard_window", "stjoin_sim_fused",
              "round_scan", "claim_max"},
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n,M,eps_sp", [(10, 40, 15.0), (37, 70, 8.0)])
def test_k1_matches_plain(cuda, n, M, eps_sp):
    tb, _ = ais_like(n_vessels=n, max_points=M, seed=n, device=cuda)
    before = kernels.LAUNCHES["stjoin_best_match"]
    k = best_match_join_kernel(tb, tb, eps_sp, 120.0)
    assert kernels.LAUNCHES["stjoin_best_match"] == before + 1
    T = tb.num_trajs
    w, i = stjoin_ref(tb.x.reshape(-1), tb.y.reshape(-1), tb.t.reshape(-1),
                      tb.traj_id[:, None].expand(T, M).reshape(-1),
                      tb.valid.reshape(-1), tb.x, tb.y, tb.t, tb.traj_id,
                      tb.valid, eps_sp, 120.0)
    assert torch.equal(k.best_idx.view(T * M, -1), i)
    assert torch.equal(k.best_w.view(T * M, -1), w)
    assert bool((i >= 0).any())


@pytest.mark.parametrize("w", [1, 7, 45])
def test_k3_matches_plain(cuda, w):
    rng = np.random.default_rng(w)
    bits = torch.from_numpy(rng.uniform(size=(6, 40, 200)) < 0.3)
    valid = torch.from_numpy(rng.uniform(size=(6, 40)) < 0.8).to(cuda)
    m = pack_bits(bits).to(cuda)
    k = window_jaccard(m, valid, w=w)
    p = tseg.tsa2_signal(torch.where(valid[..., None], m, 0), w)
    assert torch.equal(k, p)


@pytest.mark.parametrize("S", [200, 5000])
def test_k5_k6_match_plain(cuda, S):
    rng = np.random.default_rng(S)
    sim = (rng.integers(1, 5, (S, S)) / 4 * (rng.uniform(size=(S, S)) > 0.5)
           ).astype(np.float32)
    sim = np.maximum(sim, sim.T)
    np.fill_diagonal(sim, 0.0)
    rank = rng.permutation(S).astype(np.int32)
    unres = rng.uniform(size=S) < 0.4
    rep = ~unres & (rng.uniform(size=S) < 0.5)
    valid = rng.uniform(size=S) < 0.9
    cpu = [torch.from_numpy(a) for a in (sim, rank, unres, rep, valid)]
    gpu = [a.to(cuda) for a in cpu]
    kb, kc = cluster_round_scan(*gpu[:4], 0.5)
    pb, pc = cluster_round_scan(*cpu[:4], 0.5)
    assert torch.equal(kb.cpu(), pb) and torch.equal(kc.cpu(), pc)
    kw, ks = cluster_assign(gpu[0], gpu[1], gpu[3], gpu[4], 0.5)
    pw, ps = cluster_assign(cpu[0], cpu[1], cpu[3], cpu[4], 0.5)
    assert torch.equal(kw.cpu(), pw) and torch.equal(ks.cpu(), ps)


@pytest.mark.parametrize("mode", sorted(PATH_KERNELS))
def test_run_dsc_kernel_plan_matches_cpu(cuda, mode):
    """The kernel plan on the card and the plain versions on the CPU; the
    card run launches exactly its path's kernels."""
    tb, _ = figure1_scenario(n_per_route=4, points_per_leg=24, seed=0,
                             device="cpu")
    p = DSCParams(eps_sp=0.42, eps_t=1.0, w=6, tau=0.15, alpha_sigma=-1.0,
                  k_sigma=-1.0, segmentation="tsa2")
    plan = EnginePlan(mode=mode, use_kernel=True, seg_use_kernel=True,
                      cluster_use_kernel=True)
    kernels.reset_launch_counts()
    g = run_dsc(tb, p, plan=plan, device=cuda)
    assert {k for k, n in kernels.LAUNCHES.items() if n > 0} \
        == PATH_KERNELS[mode]
    c = run_dsc(tb, p, plan=plan, device="cpu")
    for f in ("member_of", "is_rep", "is_outlier"):
        assert torch.equal(getattr(g.result, f).cpu(), getattr(c.result, f))
    assert torch.equal(g.seg.sub_local.cpu(), c.seg.sub_local)


def _fused_case(cuda, n, M, C, Mc, eps_sp):
    """A reference batch and (for C != n) a separate candidate batch."""
    ref, _ = ais_like(n_vessels=n, max_points=M, seed=n, device=cuda)
    cand = ref if C == n else ais_like(n_vessels=C, max_points=Mc,
                                       seed=C, device=cuda)[0]
    arrays = lambda b: (b.x, b.y, b.t, b.valid, b.traj_id)
    return ref, cand, arrays(ref) + arrays(cand)


@pytest.mark.parametrize("n,M,C,Mc,eps_sp,delta_t", [
    (10, 40, 10, 40, 15.0, 0.0), (37, 70, 37, 70, 8.0, 300.0),
    (9, 130, 45, 20, 20.0, 200.0)])
def test_k2_matches_plain(cuda, n, M, C, Mc, eps_sp, delta_t):
    ref, cand, arrs = _fused_case(cuda, n, M, C, Mc, eps_sp)
    ref_ops, cand_ops = stjoin_ops._flat_operands(*arrs)
    for with_masks in (True, False):
        before = kernels.LAUNCHES["stjoin_vote_fused"]
        kv, kw = stjoin_ops.stjoin_vote_fused_arrays(
            *arrs, eps_sp, 120.0, delta_t, with_masks=with_masks)
        assert kernels.LAUNCHES["stjoin_vote_fused"] == before + 1
        pv, pw = stjoin_vote_fused_ref(*ref_ops, *cand_ops, eps_sp, 120.0,
                                       delta_t, M=M, with_words=with_masks)
        assert torch.equal(kv.view(-1), pv)
        if with_masks:
            assert torch.equal(kw.view(pw.shape), pw)
            assert bool((pw != 0).any())
        else:
            assert kw is None


@pytest.mark.parametrize("n,M,C,Mc,eps_sp,delta_t", [
    (10, 40, 10, 40, 15.0, 0.0), (37, 70, 37, 70, 8.0, 300.0),
    (9, 130, 45, 20, 20.0, 200.0)])
def test_k4_matches_plain(cuda, n, M, C, Mc, eps_sp, delta_t):
    ref, cand, arrs = _fused_case(cuda, n, M, C, Mc, eps_sp)
    rng = np.random.default_rng(n)
    ms = 4
    rsub = torch.from_numpy(rng.integers(-1, ms, (n, M)).astype(np.int32))
    csub = torch.from_numpy(rng.integers(-1, ms, (C, Mc)).astype(np.int32))
    before = kernels.LAUNCHES["stjoin_sim_fused"]
    raw = stjoin_ops.stjoin_sim_fused(ref, cand, rsub.to(cuda),
                                      csub.to(cuda), ms, eps_sp, 120.0,
                                      delta_t)
    assert kernels.LAUNCHES["stjoin_sim_fused"] == before + 1
    ref_ops, cand_ops = stjoin_ops._flat_operands(*arrs)
    plain = stjoin_sim_fused_ref(
        *ref_ops, slot_ids(rsub, ms, n * ms).view(-1).to(cuda), *cand_ops,
        slot_ids(csub, ms, C * ms).to(cuda), eps_sp, 120.0, delta_t, M=M,
        n_src=n * ms, n_dst=C * ms)
    assert torch.equal(raw, plain)
    assert bool((plain > 0).any())
