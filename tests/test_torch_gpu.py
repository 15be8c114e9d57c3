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
from repro_torch.core.types import DSCParams, TrajectoryBatch
from repro_torch.core.windows import pack_bits
from repro_torch.data.synthetic import ais_like, figure1_scenario
from repro_torch.kernels.cluster.ops import (cluster_assign,
                                             cluster_round_scan,
                                             topk_cluster_assign,
                                             topk_cluster_round_scan)
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import (flash_attention_ref,
                                               kernel_tolerance)
from repro_torch.kernels.jaccard.ops import window_jaccard
from repro_torch.kernels.lcss import ops as lcss_ops
from repro_torch.kernels.lcss import ref as lcss_ref
from repro_torch.kernels.stjoin import ops as stjoin_ops
from repro_torch.kernels.stjoin.ops import best_match_join_kernel
from repro_torch.kernels.stjoin.ref import (stjoin_pruned_ref, stjoin_ref,
                                            stjoin_sim_fused_ref,
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
    "materialize+index": {"stjoin_best_match_pruned", "jaccard_window",
                          "round_scan", "claim_max"},
    "fused+index": {"stjoin_vote_fused_pruned", "jaccard_window",
                    "stjoin_sim_fused_pruned", "round_scan", "claim_max"},
    "fused_topk+index": {"stjoin_vote_fused_pruned", "jaccard_window",
                         "stjoin_sim_panel_fused_pruned", "topk_round_scan",
                         "topk_claim_max"},
}
# lane-clustered traffic, rows sorted by lane: the port's plans skip tiles
LANE_EPS = (3.0, 600.0)


def _path_plan(path, **kw):
    path, _, index = path.partition("+")
    mode, _, sim = path.partition("_")
    return EnginePlan(mode=mode, sim_mode=sim or "dense", use_kernel=True,
                      seg_use_kernel=True, cluster_use_kernel=True,
                      use_index=index == "index", **kw)


def _lanes(cuda, n=128, M=16):
    """``benchmarks/kernel_bench.py``'s layout: AIS-like vessels on 8
    lanes, rows stably sorted by lane."""
    tb, lanes = ais_like(n_vessels=n, n_lanes=8, max_points=M, area=100.0,
                         lane_width=0.5, seed=1, device=cuda)
    o = torch.from_numpy(np.argsort(lanes, kind="stable")).to(cuda)
    return TrajectoryBatch(x=tb.x[o], y=tb.y[o], t=tb.t[o],
                           valid=tb.valid[o], traj_id=tb.traj_id[o])


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
    card run launches exactly its path's kernels (the pruned paths on the
    lane-sorted batch, whose plans skip tiles)."""
    if mode.endswith("+index"):
        tb = _lanes(cuda).to("cpu")
        p = DSCParams(eps_sp=LANE_EPS[0], eps_t=LANE_EPS[1], w=4, tau=0.4,
                      alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")
    else:
        tb, _ = figure1_scenario(n_per_route=4, points_per_leg=24, seed=0,
                                 device="cpu")
        p = DSCParams(eps_sp=0.42, eps_t=1.0, w=6, tau=0.15,
                      alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")
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


# ---------------------------------------------------------------------------
# The pruned kernels K10-K13: each bitwise its dense kernel and its plain
# version, on a lane-sorted batch whose plans skip tiles.
# ---------------------------------------------------------------------------


def _flat(tb):
    return stjoin_ops._flat_operands(*(tb.x, tb.y, tb.t, tb.valid,
                                       tb.traj_id) * 2)


def test_k10_matches_k1_and_plain(cuda):
    tb = _lanes(cuda)
    mask, _, _ = stjoin_ops.plan_join_index(tb, tb, *LANE_EPS)
    assert 0 < int(mask.sum()) < mask.numel()
    before = kernels.LAUNCHES["stjoin_best_match_pruned"]
    k = stjoin_ops.best_match_join_pruned(tb, tb, *LANE_EPS)
    assert kernels.LAUNCHES["stjoin_best_match_pruned"] == before + 1
    d = best_match_join_kernel(tb, tb, *LANE_EPS)
    assert torch.equal(k.best_w, d.best_w)
    assert torch.equal(k.best_idx, d.best_idx)
    ref_ops, cand_ops = _flat(tb)
    tile_ids = stjoin_ops._compact(mask, mask.sum(1), None, "join")
    w, i = stjoin_pruned_ref(*ref_ops, *cand_ops, tile_ids, *LANE_EPS,
                             bp=stjoin_ops.JOIN_BP, bc=stjoin_ops.JOIN_BC)
    T, M = tb.x.shape
    assert torch.equal(k.best_w.view(T * M, -1), w)
    assert torch.equal(k.best_idx.view(T * M, -1), i)
    assert bool((i >= 0).any())
    with pytest.raises(ValueError, match="bp=256, bc=8"):
        stjoin_ops.best_match_join_pruned(tb, tb, *LANE_EPS, bp=256, bc=8)


def _fused_plan(tb, **kw):
    return stjoin_ops.plan_fused_tiles(*(tb.x, tb.y, tb.t, tb.valid) * 2,
                                       *LANE_EPS, **kw)


@pytest.mark.parametrize("delta_t", [0.0, 300.0])
def test_k11_matches_k2_and_plain(cuda, delta_t):
    tb = _lanes(cuda)
    plan = _fused_plan(tb)
    kept = int((plan.tile_ids >= 0).sum())
    assert 0 < kept < plan.tile_ids.shape[0] * 4
    arrs = (tb.x, tb.y, tb.t, tb.valid, tb.traj_id) * 2
    ref_ops, cand_ops = _flat(tb)
    M = tb.x.shape[1]
    for with_masks in (True, False):
        before = kernels.LAUNCHES["stjoin_vote_fused_pruned"]
        kv, kw = stjoin_ops.stjoin_vote_fused_arrays(
            *arrs, *LANE_EPS, delta_t, tile_ids=plan, with_masks=with_masks)
        assert kernels.LAUNCHES["stjoin_vote_fused_pruned"] == before + 1
        dv, dw = stjoin_ops.stjoin_vote_fused_arrays(
            *arrs, *LANE_EPS, delta_t, with_masks=with_masks)
        pv, pw = stjoin_vote_fused_ref(
            *ref_ops, *cand_ops, *LANE_EPS, delta_t, M=M,
            with_words=with_masks, tiles=(plan.tile_ids, M, plan.bc))
        assert torch.equal(kv, dv) and torch.equal(kv.view(-1), pv)
        if with_masks:
            assert torch.equal(kw, dw) and torch.equal(kw.view(pw.shape), pw)
            assert bool((pw != 0).any())
        else:
            assert kw is None and dw is None and pw is None
    other = _fused_plan(tb, rows=2, bc=16)
    with pytest.raises(ValueError, match="rows=2, bc=16"):
        stjoin_ops.stjoin_vote_fused_arrays(*arrs, *LANE_EPS,
                                            tile_ids=other)


@pytest.mark.parametrize("delta_t", [0.0, 300.0])
def test_k12_matches_k4_and_plain(cuda, delta_t):
    tb = _lanes(cuda)
    plan = _fused_plan(tb)
    rng = np.random.default_rng(3)
    ms = 4
    T, M = tb.x.shape
    sub = torch.from_numpy(rng.integers(-1, ms, (T, M)).astype(np.int32))
    sub = sub.to(cuda)
    before = kernels.LAUNCHES["stjoin_sim_fused_pruned"]
    raw = stjoin_ops.stjoin_sim_fused(tb, tb, sub, sub, ms, *LANE_EPS,
                                      delta_t, tile_ids=plan)
    assert kernels.LAUNCHES["stjoin_sim_fused_pruned"] == before + 1
    dense = stjoin_ops.stjoin_sim_fused(tb, tb, sub, sub, ms, *LANE_EPS,
                                        delta_t)
    assert torch.equal(raw, dense)
    ref_ops, cand_ops = _flat(tb)
    gid = slot_ids(sub, ms, T * ms)
    plain = stjoin_sim_fused_ref(
        *ref_ops, gid.view(-1), *cand_ops, gid, *LANE_EPS, delta_t, M=M,
        n_src=T * ms, n_dst=T * ms, tiles=(plan.tile_ids, M, plan.bc))
    assert torch.equal(raw, plain)
    assert bool((plain > 0).any())


@pytest.mark.parametrize("ms,Sb,delta_t", [(3, 13, 0.0), (8, 128, 300.0)])
def test_k13_matches_k7_and_plain(cuda, ms, Sb, delta_t):
    """Every panel: K13's slabs bitwise K7's and its plain version's; Sb =
    13 with ms = 3 splits trajectories' slots, and panels cross tiles."""
    tb = _lanes(cuda)
    plan = _fused_plan(tb)
    rng = np.random.default_rng(ms)
    T, M = tb.x.shape
    sub = torch.from_numpy(rng.integers(-1, ms, (T, M)).astype(np.int32))
    sub = sub.to(cuda)
    S = T * ms
    ref_ops, cand_ops = _flat(tb)
    gid = slot_ids(sub, ms, S)
    hit = False
    for p0 in range(0, S - Sb + 1, Sb):
        before = kernels.LAUNCHES["stjoin_sim_panel_fused_pruned"]
        fwd, rev = stjoin_ops.stjoin_sim_panel_fused(
            tb, tb, sub, sub, ms, *LANE_EPS, delta_t, p0=p0, panel=Sb,
            tile_ids=plan)
        assert kernels.LAUNCHES["stjoin_sim_panel_fused_pruned"] \
            == before + 1
        df, dr = stjoin_ops.stjoin_sim_panel_fused(
            tb, tb, sub, sub, ms, *LANE_EPS, delta_t, p0=p0, panel=Sb)
        pf, pr = stjoin_sim_panel_fused_ref(
            *ref_ops, gid.view(-1), *cand_ops, gid, *LANE_EPS, delta_t, M=M,
            n_src=S, n_dst=S, p0=p0, panel=Sb,
            tiles=(plan.tile_ids, M, plan.bc))
        assert torch.equal(fwd, df) and torch.equal(rev, dr), p0
        assert torch.equal(fwd, pf) and torch.equal(rev, pr), p0
        hit |= bool((pf > 0).any())
    assert hit


# ---------------------------------------------------------------------------
# K14 (LCSS wavefront) and K15 (attention forward), the entry points off the
# DSC paths.
# ---------------------------------------------------------------------------


def _lcss_pairs(cuda, B, N, M, seed, p_valid=0.9):
    rng = np.random.default_rng(seed)
    cols = []
    for n in (N, M):
        cols += [rng.uniform(0, 5, (B, n)), rng.uniform(0, 5, (B, n)),
                 np.sort(rng.uniform(0, 50, (B, n)), 1)]
        cols.append(rng.uniform(0, 1, (B, n)) < p_valid)
    out = [torch.from_numpy(c.astype(np.float32) if c.dtype != bool else c)
           .to(cuda) for c in cols]
    return out, 2.0, 25.0


@pytest.mark.parametrize("B,N,M,p_valid", [
    (64, 128, 128, 0.9), (37, 33, 17, 0.9), (20, 1, 40, 1.0),
    (20, 40, 1, 1.0), (9, 300, 70, 0.8), (5, 16, 16, 0.0)])
def test_k14_matches_plain(cuda, B, N, M, p_valid):
    """K14 bitwise its sheared plain twin and the row scan, and on the
    transposed pairs; N != M, N = 1, M = 1, more rows than threads, and
    all-invalid pairs (score 0)."""
    ops, eps_sp, eps_t = _lcss_pairs(cuda, B, N, M, B + N + M, p_valid)
    before = kernels.LAUNCHES["lcss_wavefront"]
    got = lcss_ops.lcss_wavefront(*ops, eps_sp, eps_t)
    assert kernels.LAUNCHES["lcss_wavefront"] == before + 1
    twin = lcss_ref.lcss_wavefront_ref(lcss_ref.shear_weights(*ops, eps_sp,
                                                              eps_t))
    assert torch.equal(got, twin)
    if N * M <= 1200:
        assert torch.equal(got, lcss_ref.lcss_ref(*ops, eps_sp, eps_t))
    swapped = lcss_ops.lcss_wavefront(*ops[4:], *ops[:4], eps_sp, eps_t)
    assert torch.equal(got, swapped)
    assert bool((got[:, 0] >= 0).all()) and bool((got[:, 0] <= got[:, 1]).all())
    if p_valid == 0.0:
        assert not bool(got.any())
    else:
        assert bool((got[:, 1] > 0).any())


def test_lcss_entry_points_launch_k14_once(cuda):
    ops, eps_sp, eps_t = _lcss_pairs(cuda, 8, 24, 24, 0)
    arrays = [o.cpu().numpy() for o in ops]
    for fn in (lcss_ops.lcss_scores, lcss_ops.lcss_similarity):
        kernels.reset_launch_counts()
        got = fn(*arrays, eps_sp, eps_t)
        assert got.is_cuda
        assert {k: n for k, n in kernels.LAUNCHES.items() if n} \
            == {"lcss_wavefront": 1}
        want = fn(*arrays, eps_sp, eps_t, device="cpu")
        assert torch.equal(got.cpu(), want)


# a fully masked row against the mean of v (every probability is exactly
# 1, so only the output is rounded) and the entry point against the CPU
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
            torch.bfloat16: dict(atol=1e-3, rtol=1e-2)}
ATTN_MASKS = {
    "causal": dict(),
    "window_prefix_softcap": dict(window=8, prefix=12, softcap=30.0),
    "decode_max_kv": dict(max_kv=40),
    "fully_masked": dict(window=4),
}


def _attn_case(cuda, mask, dtype, hd):
    rng = np.random.default_rng(hd)
    Lq, M, KV, G = {"decode_max_kv": (1, 96), "fully_masked": (40, 70)}.get(
        mask, (70, 70)) + (2, 3)
    q = rng.normal(0, 1, (2, Lq, KV, G, hd)) * hd ** -0.5
    k, v = (rng.normal(0, 1, (2, M, KV, hd)) for _ in range(2))
    qkv = [torch.from_numpy(a.astype(np.float32)).to(dtype).to(cuda)
           for a in (q, k, v)]
    qp = np.arange(Lq) + (40 if mask == "decode_max_kv" else 0)
    kp = np.arange(M) + (10 if mask == "fully_masked" else 0)
    pos = [torch.from_numpy(p.astype(np.int32)).to(cuda) for p in (qp, kp)]
    return qkv, pos


@pytest.mark.parametrize("hd", [16, 64, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask", sorted(ATTN_MASKS))
def test_k15_matches_plain(cuda, mask, dtype, hd):
    """K15 within its tolerance of the plain version (``kernel_tolerance``),
    for each mask kind and both dtypes (a fully masked row averages v), M
    not a multiple of the kernel's 32-key tile."""
    (q, k, v), (qp, kp) = _attn_case(cuda, mask, dtype, hd)
    kw = ATTN_MASKS[mask]
    args = (kw.get("window", attn_ops.HUGE), kw.get("prefix", 0),
            kw.get("max_kv", attn_ops.HUGE))
    before = kernels.LAUNCHES["flash_attention_fwd"]
    got = attn_ops.flash_attention_fwd(q, k, v, qp, kp, *args,
                                       softcap=kw.get("softcap"))
    assert kernels.LAUNCHES["flash_attention_fwd"] == before + 1
    want = flash_attention_ref(q, k, v, qp, kp, *args,
                               softcap=kw.get("softcap"))
    assert got.dtype == dtype and got.shape == q.shape
    tol = kernel_tolerance(q, k, v, qp, kp, *args, kw.get("softcap"), want)
    used = float(((got.float() - want.float()).abs() / tol).max())
    assert used <= 1.0, f"{used:.3g} of the tolerance"
    if mask == "fully_masked":
        mean = v.float().mean(dim=1)[:, None, :, None, :].expand(q.shape)
        torch.testing.assert_close(got[:, :10].float(), mean[:, :10],
                                   **ATTN_TOL[dtype])


def test_flash_attention_launches_k15_once(cuda):
    (q, k, v), (qp, kp) = _attn_case(cuda, "causal", torch.float32, 64)
    kernels.reset_launch_counts()
    got = attn_ops.flash_attention(q, k, v, qp, kp, window=16)
    assert {k_: n for k_, n in kernels.LAUNCHES.items() if n} \
        == {"flash_attention_fwd": 1}
    want = attn_ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), qp.cpu(),
                                    kp.cpu(), window=16, device="cpu")
    torch.testing.assert_close(got.cpu(), want, **ATTN_TOL[torch.float32])
