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
from repro_torch.core.similarity import (plan_panel, slot_ids,
                                         topk_from_dense, topk_reduce_rows)
from repro_torch.core.types import DSCParams
from repro_torch.core.windows import pack_bits
from repro_torch.data.synthetic import ais_like, figure1_scenario
from repro_torch.kernels.cluster.ops import (cluster_assign,
                                             cluster_round_scan,
                                             topk_cluster_assign,
                                             topk_cluster_round_scan)
from repro_torch.kernels.jaccard.ops import window_jaccard
from repro_torch.kernels.stjoin import ops as stjoin_ops
from repro_torch.kernels.stjoin.ops import best_match_join_kernel
from repro_torch.kernels.stjoin.ref import (stjoin_ref, stjoin_sim_fused_ref,
                                            stjoin_sim_panel_fused_ref,
                                            stjoin_vote_fused_ref)

pytestmark = pytest.mark.gpu

# the kernels each path of the kernel plan launches, and no other
PATH_KERNELS = {
    "materialize": {"stjoin_best_match", "jaccard_window", "round_scan",
                    "claim_max"},
    "fused": {"stjoin_vote_fused", "jaccard_window", "stjoin_sim_fused",
              "round_scan", "claim_max"},
    "materialize_topk": {"stjoin_best_match", "jaccard_window",
                         "topk_round_scan", "topk_claim_max"},
    "fused_topk": {"stjoin_vote_fused", "jaccard_window",
                   "stjoin_sim_panel_fused", "topk_round_scan",
                   "topk_claim_max"},
}


def _path_plan(path, **kw):
    mode, _, sim = path.partition("_")
    return EnginePlan(mode=mode, sim_mode=sim or "dense", use_kernel=True,
                      seg_use_kernel=True, cluster_use_kernel=True, **kw)


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
    plan = _path_plan(mode)
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


@pytest.mark.parametrize("n,M,eps_sp,delta_t,ms,Sb", [
    (10, 40, 15.0, 0.0, 4, 8), (13, 70, 8.0, 300.0, 3, 13),
    (37, 50, 10.0, 0.0, 8, 37)])
def test_k7_matches_plain_and_k4(cuda, n, M, eps_sp, delta_t, ms, Sb):
    """Every panel: K7's two slabs bitwise equal to its plain version and
    to the K4 kernel's raw rows and transposed columns.  Sb = 13 with
    ms = 3 and Sb = 37 with ms = 8 split trajectories' slots."""
    tb, _ = ais_like(n_vessels=n, max_points=M, seed=n, device=cuda)
    rng = np.random.default_rng(n)
    sub = torch.from_numpy(rng.integers(-1, ms, (n, M)).astype(np.int32))
    sub = sub.to(cuda)
    raw = stjoin_ops.stjoin_sim_fused(tb, tb, sub, sub, ms, eps_sp, 120.0,
                                      delta_t)
    S = n * ms
    arrs = (tb.x, tb.y, tb.t, tb.valid, tb.traj_id) * 2
    ref_ops, cand_ops = stjoin_ops._flat_operands(*arrs)
    gid = slot_ids(sub, ms, S)
    for p0 in range(0, S, Sb):
        before = kernels.LAUNCHES["stjoin_sim_panel_fused"]
        fwd, rev = stjoin_ops.stjoin_sim_panel_fused(
            tb, tb, sub, sub, ms, eps_sp, 120.0, delta_t, p0=p0, panel=Sb)
        assert kernels.LAUNCHES["stjoin_sim_panel_fused"] == before + 1
        pf, pr = stjoin_sim_panel_fused_ref(
            *ref_ops, gid.view(-1), *cand_ops, gid, eps_sp, 120.0, delta_t,
            M=M, n_src=S, n_dst=S, p0=p0, panel=Sb)
        assert torch.equal(fwd, pf) and torch.equal(rev, pr), p0
        assert torch.equal(fwd, raw[p0:p0 + Sb]), p0
        assert torch.equal(rev, raw.T[p0:p0 + Sb]), p0
    assert bool((raw > 0).any())


def _lists(rng, S, K, cuda):
    """Random ``[S, K]`` lists: distinct ids per row, -1 padding past a
    random degree, sims from a few values (ties) and descending."""
    ids = np.full((S, K), -1, np.int32)
    sims = np.zeros((S, K), np.float32)
    for s in range(S):
        deg = int(rng.integers(0, K + 1))
        ids[s, :deg] = rng.choice(S, deg, replace=False)
        sims[s, :deg] = np.sort(rng.integers(1, 6, deg) / 5)[::-1]
    return (torch.from_numpy(ids).to(cuda),
            torch.from_numpy(sims).to(cuda))


@pytest.mark.parametrize("S,K", [(300, 7), (5000, 64)])
def test_k8_k9_match_plain(cuda, S, K):
    rng = np.random.default_rng(S)
    ids, sims = _lists(rng, S, K, cuda)
    rank = torch.from_numpy(rng.permutation(S).astype(np.int32)).to(cuda)
    unres = torch.from_numpy(rng.uniform(size=S) < 0.4).to(cuda)
    rep = ~unres & torch.from_numpy(rng.uniform(size=S) < 0.5).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=S) < 0.9).to(cuda)
    before = dict(kernels.LAUNCHES)
    kb, kc = topk_cluster_round_scan(ids, sims, rank, unres, rep, 0.4)
    kw, ks = topk_cluster_assign(ids, sims, rank, rep, valid, 0.4)
    assert kernels.LAUNCHES["topk_round_scan"] == before["topk_round_scan"] + 1
    assert kernels.LAUNCHES["topk_claim_max"] == before["topk_claim_max"] + 1
    cpu = [t.cpu() for t in (ids, sims, rank, unres, rep, valid)]
    pb, pc = topk_cluster_round_scan(*cpu[:5], 0.4)
    pw, ps = topk_cluster_assign(*cpu[:3], cpu[4], cpu[5], 0.4)
    assert torch.equal(kb.cpu(), pb) and torch.equal(kc.cpu(), pc)
    assert torch.equal(kw.cpu(), pw) and torch.equal(ks.cpu(), ps)
    assert bool(pb.any()) and bool(pc.any()) and bool((ps >= 0).any())


def test_topk_tie_order_on_card(cuda):
    """The stable descending sort keeps ties in ascending column order on
    the card too (the TopKSim contract), also in rows longer than the
    card's small-sort sizes."""
    rng = np.random.default_rng(0)
    for n in (100, 3000, 40000):
        rows = (rng.integers(0, 4, (6, n)) / 4).astype(np.float32)
        x = torch.from_numpy(rows)
        for k in (1, 17, n):
            got = topk_reduce_rows(x.to(cuda), k)
            want = topk_reduce_rows(x, k)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), (n, k)


def test_run_dsc_topk_kernel_plan(cuda):
    """The fused top-K kernel plan on the card: labels equal to the dense
    fused kernel plan, lists bitwise ``topk_from_dense`` of its matrix,
    and the launch counts K7 = dispatches x S/Sb, K8 = rounds summed over
    the dispatches, K9 = dispatches.  K starts at 4, so K widens."""
    tb, _ = ais_like(n_vessels=48, max_points=64, n_lanes=8, seed=0,
                     device=cuda)
    p = DSCParams(eps_sp=15.0, eps_t=120.0, w=8, tau=0.4, alpha_sigma=-1.0,
                  k_sigma=-1.0, segmentation="tsa2")
    dense = run_dsc(tb, p, plan=_path_plan("fused"), device=cuda)
    kernels.reset_launch_counts()
    out = run_dsc(tb, p, plan=_path_plan("fused_topk", sim_topk=4),
                  device=cuda)
    n = dict(kernels.LAUNCHES)
    assert out.dispatches > 1 and out.sim_topk.k == 4 << (out.dispatches - 1)
    assert {k for k, v in n.items() if v > 0} == PATH_KERNELS["fused_topk"]
    S = out.table.num_slots
    assert n["stjoin_sim_panel_fused"] == out.dispatches * S // plan_panel(S)
    assert n["topk_round_scan"] == out.rounds
    assert n["topk_claim_max"] == out.dispatches
    assert n["stjoin_vote_fused"] == n["jaccard_window"] == 1
    assert out.sim is None and int(out.sim_overflow) == 0
    for f in ("member_of", "member_sim", "is_rep", "is_outlier"):
        assert torch.equal(getattr(out.result, f), getattr(dense.result, f))
    want = topk_from_dense(dense.sim, dense.table, out.sim_topk.k)
    for f in ("ids", "sims", "spill", "degree", "row_sum", "row_sumsq"):
        assert torch.equal(getattr(out.sim_topk, f), getattr(want, f)), f
