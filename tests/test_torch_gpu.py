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
from repro_torch.core.clustering import cluster_rounds, cluster_rounds_topk
from repro_torch.core.similarity import (plan_panel, slot_ids,
                                         topk_from_dense, topk_reduce_rows)
from repro_torch.core.types import DSCParams, TrajectoryBatch
from repro_torch.data.synthetic import (ais_like, default_dsc_params_for,
                                        figure1_scenario)
from repro_torch.kernels.cluster.ops import (cluster_assign,
                                             cluster_round_scan,
                                             sim_row_moments,
                                             topk_cluster_assign,
                                             topk_cluster_round_scan)
from repro_torch.kernels.cluster.ref import (claim_max_schedule_ref,
                                             claim_splits,
                                             cluster_assign_ref,
                                             round_scan_ref,
                                             sim_row_moments_ref,
                                             topk_claim_max_schedule_ref)
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import (flash_attention_ref,
                                               kernel_tolerance,
                                               tile_class_ref)
from repro_torch.kernels.jaccard import ops as jaccard_ops
from repro_torch.kernels.jaccard.ops import window_jaccard
from repro_torch.kernels.jaccard.ref import jaccard_schedule_ref
from repro_torch.kernels.lcss import ops as lcss_ops
from repro_torch.kernels.lcss import ref as lcss_ref
from repro_torch.kernels.stjoin import ops as stjoin_ops
from repro_torch.kernels.stjoin.ops import best_match_join_kernel
from repro_torch.kernels.stjoin.ref import (stjoin_pruned_ref, stjoin_ref,
                                            stjoin_sim_fused_ref,
                                            stjoin_sim_panel_fused_ref,
                                            stjoin_vote_fused_ref)

pytestmark = pytest.mark.gpu

# the kernels each path of the kernel plan launches, and no other (every
# path's join reads the chunk time bounds, its thresholds the row moments)
PATH_KERNELS = {path: {"chunk_time_bounds", "sim_row_moments", *names}
                for path, names in {
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
}.items()}
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


def _join_batch(cuda, n, M, times="ais", seed=None):
    tb, _ = ais_like(n_vessels=n, max_points=M, seed=n if seed is None
                     else seed, device=cuda)
    return _retime(tb, times, seed=n)


def _ties(cuda):
    """Exact distance ties: every candidate point repeated (the same x, y
    and t at two indices), and reference points on the candidates' own
    points, so equal weights compete and the first index must win."""
    ref = _join_batch(cuda, 12, 24)
    rep = lambda a: a.repeat_interleave(2, dim=1)
    cand = TrajectoryBatch(x=rep(ref.x), y=rep(ref.y), t=rep(ref.t),
                           valid=rep(ref.valid), traj_id=ref.traj_id + 100)
    return ref, cand


# name: (reference batch, candidate batch, eps_sp, eps_t).  P = T * M is
# no multiple of 64 and C no multiple of 32 unless said; Mc = 1, 129 and
# 300 stage the candidates in one, two and three windows; eps_t = 0 keeps
# only chunks holding an exactly equal time, eps_t = inf skips only empty
# ones (here none: every point valid); all points invalid skips all
K1_CASES = {
    "ais_10x40": lambda c: (_join_batch(c, 10, 40),) * 2 + (15.0, 120.0),
    "ais_37x70": lambda c: (_join_batch(c, 37, 70),) * 2 + (8.0, 120.0),
    "mc_1": lambda c: (_join_batch(c, 9, 45), _first(_join_batch(c, 70, 20)),
                       20.0, 120.0),
    "mc_129": lambda c: (_join_batch(c, 7, 50), _join_batch(c, 45, 129),
                         15.0, 120.0),
    "mc_300": lambda c: (_join_batch(c, 5, 37), _join_batch(c, 33, 300),
                         15.0, 120.0),
    "eps_t_0": lambda c: (_join_batch(c, 37, 50, "grid60"),) * 2
                         + (10.0, 0.0),
    "eps_t_inf": lambda c: (_all_valid(_join_batch(c, 20, 33)),) * 2
                           + (15.0, float("inf")),
    "all_invalid": lambda c: (_none_valid(_join_batch(c, 11, 30)),) * 2
                             + (15.0, 120.0),
    "ties": lambda c: _ties(c) + (15.0, 120.0),
    "epoch": lambda c: (_join_batch(c, 12, 45, "epoch"),
                        _join_batch(c, 40, 150, "epoch"), 15.0, 130.0),
    "unsorted": lambda c: (_join_batch(c, 35, 33, "unsorted"),) * 2
                          + (10.0, 120.0),
}


def _first(tb):
    """Each trajectory's first point only (Mc = 1)."""
    return TrajectoryBatch(x=tb.x[:, :1].contiguous(),
                           y=tb.y[:, :1].contiguous(),
                           t=tb.t[:, :1].contiguous(),
                           valid=tb.valid[:, :1].contiguous(),
                           traj_id=tb.traj_id)


def _all_valid(tb):
    return TrajectoryBatch(x=tb.x, y=tb.y, t=tb.t,
                           valid=torch.ones_like(tb.valid),
                           traj_id=tb.traj_id)


def _none_valid(tb):
    return TrajectoryBatch(x=tb.x, y=tb.y, t=tb.t,
                           valid=torch.zeros_like(tb.valid),
                           traj_id=tb.traj_id)


def _join_stats(ref, cand, eps_t, tile_ids=None):
    """An int64 ``stats`` tensor for one K1 / K10 launch, and the plain
    mirror's ``(swept, skipped)`` of that launch."""
    want = stjoin_ops.join_skip_counts(ref.t, ref.valid, cand.t, cand.valid,
                                       eps_t, tile_ids=tile_ids)
    return torch.zeros(2, dtype=torch.int64, device=ref.x.device), want


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_matches_plain(cuda, case):
    """K1 bitwise its plain version; its skip counts equal the plain
    mirror's (flattened groups of 8 points against every candidate)."""
    ref, cand, eps_sp, eps_t = K1_CASES[case](cuda)
    ref_ops, cand_ops = stjoin_ops._flat_operands(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id, cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id)
    stats, want = _join_stats(ref, cand, eps_t)
    before = kernels.LAUNCHES["stjoin_best_match"]
    w, i = stjoin_ops.stjoin_best_match(*ref_ops, *cand_ops, eps_sp, eps_t,
                                        stats=stats)
    assert kernels.LAUNCHES["stjoin_best_match"] == before + 1
    assert stats.tolist() == list(want)
    pw, pi = stjoin_ref(*ref_ops, *cand_ops, eps_sp, eps_t)
    assert torch.equal(i, pi) and torch.equal(w, pw)
    if case == "all_invalid":
        assert want[1] == want[0] and not bool((pi >= 0).any())
        return
    assert bool((pi >= 0).any())
    if case == "eps_t_inf":
        assert want[1] == 0
    else:
        assert 0 < want[1] < want[0]
    if case == "ties":               # of two equal copies the first wins
        assert not bool((pi[pi >= 0] % 2).any())
    if case.startswith("ais"):       # the batch-level wrapper, one launch
        k = best_match_join_kernel(ref, ref, eps_sp, eps_t)
        T, M = ref.x.shape
        assert torch.equal(k.best_idx.view(T * M, -1), pi)
        assert torch.equal(k.best_w.view(T * M, -1), pw)


@pytest.mark.parametrize("chunk", [1, 5, 8])
def test_chunk_time_bounds_kernel(cuda, chunk):
    """The chunk bounds kernel bitwise the plain ``chunk_time_bounds``,
    with invalid points, NaN times on valid points, runs without a valid
    time and rows not a multiple of the chunk."""
    rng = np.random.default_rng(chunk)
    t = rng.uniform(-50, 3000, (37, 61)).astype(np.float32)
    ok = rng.uniform(size=t.shape) < 0.7
    t[3, 5:9] = np.nan
    ok[4, :] = False
    ok[5, 10:30] = False
    tt, okt = torch.from_numpy(t), torch.from_numpy(ok)
    before = kernels.LAUNCHES["chunk_time_bounds"]
    lo, hi = stjoin_ops.chunk_time_bounds(tt.to(cuda), okt.to(cuda), chunk)
    assert kernels.LAUNCHES["chunk_time_bounds"] == before + 1
    plo, phi = stjoin_ops.chunk_time_bounds(tt, okt, chunk)
    assert torch.equal(lo.cpu(), plo) and torch.equal(hi.cpu(), phi)
    assert bool(torch.isinf(plo).any()) and bool(torch.isfinite(plo).any())


# (T, M, W, w, share of valid rows, words a view is offset by): the
# original three cases; the shape edges (W = 1, W not a multiple of 4 or
# 32, w = 1 and w > M, M = 1 and in the hundreds); a dsc-like trajectory
# block; every row invalid; slab loops past shared memory (M = 300: 19
# slabs of 16 columns; M = 5000: one column, past the 48 KB default; M =
# 12000: past the opt-in limit, the global scratch); a misaligned view
K3_CARD = ([(6, 40, 7, w, 0.8, 0) for w in (1, 7, 45)]
           + [(5, M, W, w if w else M + 3, 0.8, 0)
              for W in (1, 7, 33, 128) for M in (1, 40, 130)
              for w in (1, 20, 0)]
           + [(64, 128, 128, 20, 0.8, 0), (5, 130, 33, 7, 0.0, 0),
              (3, 300, 300, 20, 0.8, 0), (3, 5000, 4, 20, 0.8, 0),
              (3, 12000, 3, 50, 0.8, 0), (4, 128, 128, 20, 0.8, 1)])


@pytest.mark.parametrize("T,M,W,w,p_valid,offset", K3_CARD)
def test_k3_matches_plain(cuda, T, M, W, w, p_valid, offset):
    """K3 bitwise its plain version (the masked words through
    ``tsa2_signal``) and the schedule's mirror, one launch, on raw words
    whose invalid rows hold garbage (the kernel never reads them)."""
    rng = np.random.default_rng(T * M * W + w)
    raw = rng.integers(0, 2 ** 32, T * M * W + offset, dtype=np.uint64)
    raw = np.where(rng.uniform(size=raw.shape) < 0.5, raw, 0)
    store = torch.from_numpy(raw.astype(np.uint32).view(np.int32)).to(cuda)
    m = store[offset:].view(T, M, W)
    valid = torch.from_numpy(rng.uniform(size=(T, M)) < p_valid).to(cuda)
    before = kernels.LAUNCHES["jaccard_window"]
    k = window_jaccard(m, valid, w=w)
    assert kernels.LAUNCHES["jaccard_window"] == before + 1
    masked = torch.where(valid[..., None], m, 0)
    p = tseg.tsa2_signal(masked, w)
    assert torch.equal(k, p)
    if M * W <= 4096:
        J = jaccard_ops.slab_plan(M, W, kernels.smem_optin(0))[0]
        assert torch.equal(k, jaccard_schedule_ref(m, valid, w, J))
    if p_valid == 0.0:
        assert not bool(k.any())
    elif M > 1:
        assert bool((k > 0).any())


def _k5_instance(cuda, S, state, seed):
    """A symmetric matrix of weights in {0.25, 0.5, 0.75, 1} (ties, and
    alpha = 0.5 on entries), made on the card from a seed, with a round
    state: ``mixed`` (40% unresolved, half the rest representatives),
    ``sparse`` (about 10% of the rows active, as at dsc_brest's round 0),
    ``all`` (every row active, some with both flags) or ``none``."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=g, device=cuda)
    sim = torch.where(rand(S, S) > 0.5, (rand(S, S) * 4).ceil() / 4, 0.0)
    sim = torch.maximum(sim, sim.T)
    sim.fill_diagonal_(0.0)
    rank = torch.randperm(S, generator=g, device=cuda).to(torch.int32)
    p_unres, p_rep = {"mixed": (0.4, 0.5), "sparse": (0.07, 0.03),
                      "all": (0.5, 1.0), "none": (0.0, 0.0)}[state]
    unres = rand(S) < p_unres
    rep = (~unres | (rand(S) < 0.2)) if state == "all" else \
        (~unres & (rand(S) < p_rep))
    valid = rand(S) < 0.9
    return sim, rank, unres, rep, valid


# (S, state): S % 4 == 0 takes the float4 kernel, else the scalar one
# (and S = 200 again through a misaligned view); 32768 is dsc_brest's S;
# 4097_wide spreads the ranks over the int32 range
K5_CASES = [(200, "mixed"), (5000, "mixed"), (4097, "mixed"),
            (5001, "mixed"), (32768, "sparse"), (200, "all"), (4097, "all"),
            (5001, "none"), (32768, "none"), ("200_offset", "mixed"),
            ("4097_wide", "mixed")]


@pytest.mark.parametrize("S,state", K5_CASES)
def test_k5_k6_match_plain(cuda, S, state):
    """K5 and K6 (one launch each) equal to their plain versions on the
    card: K6's weights bit for bit."""
    offset, wide = S == "200_offset", S == "4097_wide"
    S = {"200_offset": 200, "4097_wide": 4097}.get(S, S)
    sim, rank, unres, rep, valid = _k5_instance(cuda, S, state, S)
    if wide:
        rank = ((rank.long() - S // 2) * (2 ** 31 // S)).to(torch.int32)
        assert int(rank.abs().max()) >= 2 ** 29
    if offset:      # rows no longer 16-byte aligned although S % 4 == 0
        buf = torch.empty(S * S + 1, device=cuda)
        buf[1:] = sim.flatten()
        sim = buf[1:].view(S, S)
        assert sim.data_ptr() % 16 != 0
    before = kernels.LAUNCHES["round_scan"]
    kb, kc = cluster_round_scan(sim, rank, unres, rep, 0.5)
    assert kernels.LAUNCHES["round_scan"] == before + 1
    pb, pc = round_scan_ref(sim, rank, unres, rep, 0.5)
    assert torch.equal(kb, pb) and torch.equal(kc, pc)
    assert bool(kb.any()) == (state != "none")
    before = kernels.LAUNCHES["claim_max"]
    kw, ks = cluster_assign(sim, rank, rep, valid, 0.5)
    assert kernels.LAUNCHES["claim_max"] == before + 1
    pw, ps = cluster_assign_ref(sim, rank, rep, valid, 0.5)
    assert torch.equal(kw.view(torch.int32), pw.view(torch.int32))
    assert torch.equal(ks, ps)
    assert bool((ks >= 0).any()) == bool(rep.any())


def _no_sync(fn):
    """``fn()`` with host syncs refused (alpha read on the card)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _graph(fn):
    """``fn`` captured in a CUDA graph (after a warm-up on a side stream),
    and a dict holding the outputs of its captured call."""
    out = {}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out["r"] = fn()
    return graph, out


@pytest.mark.parametrize("S,state", [(200, "mixed"), (4097, "all"),
                                     (5001, "none"), (32768, "sparse")])
def test_k5_alpha_on_card(cuda, S, state):
    """K5 with alpha a card tensor, as the engine passes it: one launch and
    no host sync, then captured in a CUDA graph and replayed after new
    alphas are written into that tensor; bitwise its plain version each
    time (the kernel reads the tensor, not a value fixed at capture)."""
    sim, rank, unres, rep, _ = _k5_instance(cuda, S, state, S + 1)
    alpha = torch.tensor(0.5, device=cuda)
    before = kernels.LAUNCHES["round_scan"]
    kb, kc = _no_sync(lambda: cluster_round_scan(sim, rank, unres, rep,
                                                 alpha))
    assert kernels.LAUNCHES["round_scan"] == before + 1
    pb, pc = round_scan_ref(sim, rank, unres, rep, 0.5)
    assert torch.equal(kb, pb) and torch.equal(kc, pc)
    graph, out = _graph(lambda: cluster_round_scan(sim, rank, unres, rep,
                                                   alpha))
    for a in (0.75, 0.25, 0.5):
        alpha.fill_(a)
        graph.replay()
        torch.cuda.synchronize()
        pb, pc = round_scan_ref(sim, rank, unres, rep, a)
        assert torch.equal(out["r"][0], pb) and torch.equal(out["r"][1], pc)


@pytest.mark.parametrize("S,K", [(300, 7), (5000, 64), (1000, 256)])
def test_k8_k9_alpha_on_card(cuda, S, K):
    """K8 and K9 with alpha a card tensor: one launch each and no host
    sync, then both captured in a CUDA graph and replayed at new alphas;
    bitwise their plain versions each time."""
    rng = np.random.default_rng(S + K + 1)
    ids, sims = _lists(rng, S, K, cuda)
    rank = torch.from_numpy(rng.permutation(S).astype(np.int32)).to(cuda)
    unres = torch.from_numpy(rng.uniform(size=S) < 0.4).to(cuda)
    rep = ~unres & torch.from_numpy(rng.uniform(size=S) < 0.5).to(cuda)
    valid = torch.from_numpy(rng.uniform(size=S) < 0.9).to(cuda)
    alpha = torch.tensor(0.4, device=cuda)
    call = lambda: (topk_cluster_round_scan(ids, sims, rank, unres, rep,
                                            alpha),
                    topk_cluster_assign(ids, sims, rank, rep, valid, alpha))
    before = dict(kernels.LAUNCHES)
    got = _no_sync(call)
    assert kernels.LAUNCHES["topk_round_scan"] == before["topk_round_scan"] + 1
    assert kernels.LAUNCHES["topk_claim_max"] == before["topk_claim_max"] + 1
    graph, out = _graph(call)
    cpu = [t.cpu() for t in (ids, sims, rank, unres, rep, valid)]
    for a, res in ((0.4, got), (0.8, None), (0.2, None)):
        if res is None:
            alpha.fill_(a)
            graph.replay()
            torch.cuda.synchronize()
            res = out["r"]
        (kb, kc), (kw, ks) = res
        pb, pc = topk_cluster_round_scan(*cpu[:5], a)
        pw, ps = topk_cluster_assign(*cpu[:3], cpu[4], cpu[5], a)
        assert torch.equal(kb.cpu(), pb) and torch.equal(kc.cpu(), pc), a
        assert torch.equal(kw.cpu(), pw) and torch.equal(ks.cpu(), ps), a


# name: (S, representative rows, ranks, share of valid columns, offset);
# R = S / 2 and S cut the list into many slices (merged), R <= 8 one
K6_CASES = {"dup_5000": (5000, 500, "dup", 0.9, 0),
            "dup_4097": (4097, 500, "dup", 0.9, 0),
            "r0": (32768, 0, "perm", 0.9, 0),
            "r1": (32768, 1, "dup", 0.9, 0),
            "r8": (32768, 8, "wide", 0.9, 0),
            "half": (32768, 16384, "dup", 0.9, 0),
            "all": (32768, 32768, "wide", 0.9, 0),
            "all_4097": (4097, 4097, "dup", 0.9, 0),
            "none_valid": (32768, 16384, "dup", 0.0, 0),
            "s65536": (65536, 8, "dup", 0.9, 0),
            "offset": (4096, 300, "dup", 0.9, 1)}


@pytest.mark.parametrize("case", sorted(K6_CASES))
def test_k6_matches_plain(cuda, case):
    """K6 bit for bit its plain twin, one launch and no host sync (alpha
    on the card, as the engine passes it), for duplicate ranks and ranks
    over the int32 range, R from 0 to S, no valid column, S = 65536 and a
    misaligned view with S % 4 == 0.  The matrix holds weights in
    {0.25, 0.5, 0.75, 1} on about half its entries (alpha = 0.5: ties in
    weight everywhere, and in weight and rank for duplicate ranks), made in
    place on the card from a seed (no symmetry: K6 does not need it)."""
    S, R, ranks, p_valid, offset = K6_CASES[case]
    g = torch.Generator(device=cuda).manual_seed(S + R)
    buf = torch.rand(S * S + offset, generator=g, device=cuda)
    sim = buf[offset:].view(S, S)
    assert (sim.data_ptr() % 16 != 0) == bool(offset)
    sim.sub_(0.5).mul_(8).ceil_().clamp_(min=0).div_(4)
    rank = {"perm": lambda: torch.randperm(S, generator=g, device=cuda),
            "dup": lambda: torch.randint(0, 8, (S,), generator=g,
                                         device=cuda),
            "wide": lambda: torch.randint(-2 ** 31, 2 ** 31 - 1, (S,),
                                          generator=g, device=cuda),
            }[ranks]().to(torch.int32)
    rep = torch.zeros(S, dtype=torch.bool, device=cuda)
    rep[torch.randperm(S, generator=g, device=cuda)[:R]] = True
    valid = torch.rand(S, generator=g, device=cuda) < p_valid
    alpha = torch.tensor(0.5, device=cuda)    # the engine's: on the card
    before = kernels.LAUNCHES["claim_max"]
    torch.cuda.set_sync_debug_mode("error")   # a host sync would raise
    try:
        kw, ks = cluster_assign(sim, rank, rep, valid, alpha)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.LAUNCHES["claim_max"] == before + 1
    pw, ps = cluster_assign_ref(sim, rank, rep, valid, 0.5)
    assert torch.equal(kw.view(torch.int32), pw.view(torch.int32))
    assert torch.equal(ks, ps)
    assert bool((ks >= 0).any()) == (R > 0 and p_valid > 0)
    if S <= 5000:     # the mirror, at the launcher's slice count
        n_split = kernels.library().claim_max_slices(S, S)
        mw, ms = claim_max_schedule_ref(sim, rank, rep, valid, 0.5, n_split)
        assert torch.equal(mw.view(torch.int32), kw.view(torch.int32))
        assert torch.equal(ms, ks)


@pytest.mark.parametrize("S", [1, 200, 4097, 32768, 65536])
def test_k6_slices_match_mirror(cuda, S):
    """The slices K6 cuts a list of R representative rows into, read from
    its launcher, equal ``claim_splits`` (the rule of the schedule's
    mirror) at the launcher's slice count (its count at R = S), across the
    rule's edges at 32 rows a slice."""
    lib = kernels.library()
    n_split = lib.claim_max_slices(S, S)
    assert 1 <= n_split <= max(1, -(-S // 32))
    for R in sorted({0, 1, 8, 31, 32, 33, 64, 65, 1000, S // 2, S}):
        if R <= S:
            assert lib.claim_max_slices(S, R) == claim_splits(R, n_split)


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


@pytest.mark.parametrize("mode", ["materialize", "fused", "fused_topk"])
def test_launcher_kernel_plan_matches_cpu(cuda, mode, tmp_path):
    """The launcher on a small ``ais_like`` batch (dsc_brest's generator
    and sizing at 48 vessels, TSA2) with a kernel plan file: the card run
    launches exactly its path's kernels, and its labels and segmentation
    equal the same command's with ``--device cpu``."""
    from repro_torch.launch import run_dsc as launcher
    path = tmp_path / "plan.json"
    _path_plan(mode).save(path)
    argv = ["--config", "dsc_brest", "--n-trajs", "48", "--segmentation",
            "tsa2", "--plan", str(path)]
    kernels.reset_launch_counts()
    g = launcher.main(argv)
    assert {k for k, n in kernels.LAUNCHES.items() if n > 0} \
        == PATH_KERNELS[mode]
    c = launcher.main(argv + ["--device", "cpu"])
    for f in ("member_of", "is_rep", "is_outlier"):
        assert torch.equal(getattr(g.result, f).cpu(), getattr(c.result, f))
    assert torch.equal(g.seg.sub_local.cpu(), c.seg.sub_local)
    assert g.vote.is_cuda and int(g.result.is_rep.sum()) >= 1


def _retime(tb, times, seed=0):
    """The batch with adversarial times: ``"grid60"`` rounds them to
    multiples of 60 s (pairs exactly 0 or 60 s apart), ``"epoch"`` adds
    1.7e9 in float32 (spacing 128 s), ``"unsorted"`` permutes each row's
    points; ``"ais"`` leaves them."""
    t = tb.t
    if times == "grid60":
        t = torch.round(t / 60.0) * 60.0
    elif times == "epoch":
        t = (t.double() + 1.7e9).float()
    elif times == "unsorted":
        rng = np.random.default_rng(seed)
        o = torch.from_numpy(np.argsort(rng.uniform(size=t.shape), 1))
        o = o.to(t.device)
        g = lambda a: torch.gather(a, 1, o)
        return TrajectoryBatch(x=g(tb.x), y=g(tb.y), t=g(t),
                               valid=g(tb.valid), traj_id=tb.traj_id)
    return TrajectoryBatch(x=tb.x, y=tb.y, t=t, valid=tb.valid,
                           traj_id=tb.traj_id)


def _fused_case(cuda, n, M, C, Mc, times="ais"):
    """A reference batch and (for C != n) a separate candidate batch, with
    the times of ``_retime``."""
    ref, _ = ais_like(n_vessels=n, max_points=M, seed=n, device=cuda)
    cand = ref if C == n else ais_like(n_vessels=C, max_points=Mc,
                                       seed=C, device=cuda)[0]
    ref = _retime(ref, times, seed=n)
    cand = ref if C == n else _retime(cand, times, seed=C)
    arrays = lambda b: (b.x, b.y, b.t, b.valid, b.traj_id)
    return ref, cand, arrays(ref) + arrays(cand)


def _fused_stats(ref, cand, eps_t, plan=None):
    """An int64 ``stats`` tensor for one fused launch, and the plain
    mirror's ``(swept, skipped)`` of that launch."""
    want = stjoin_ops.fused_skip_counts(ref.t, ref.valid, cand.t, cand.valid,
                                        eps_t, tile_ids=plan)
    return torch.zeros(2, dtype=torch.int64, device=ref.x.device), want


# (n, M, C, Mc, eps_sp, eps_t, delta_t, times): times on a 60 s grid with
# eps_t = 60 (pairs exactly eps_t apart), epoch-sized (float32 spacing
# 128 s), unsorted rows (chunks span the whole row); M = 130 and Mc = 150
# stage the candidates in two windows of 128 points
FUSED_CASES = [
    (10, 40, 10, 40, 15.0, 120.0, 0.0, "ais"),
    (37, 70, 37, 70, 8.0, 120.0, 300.0, "ais"),
    (9, 130, 45, 20, 20.0, 120.0, 200.0, "ais"),
    (37, 50, 37, 50, 10.0, 60.0, 0.0, "grid60"),
    (12, 45, 40, 150, 15.0, 120.0, 200.0, "epoch"),
    (35, 33, 35, 33, 10.0, 120.0, 200.0, "unsorted")]


@pytest.mark.parametrize("n,M,C,Mc,eps_sp,eps_t,delta_t,times", FUSED_CASES)
def test_k2_matches_plain(cuda, n, M, C, Mc, eps_sp, eps_t, delta_t, times):
    """K2's vote and words bitwise its plain version; its skip counts equal
    the plain mirror's over every (row, candidate) pair."""
    ref, cand, arrs = _fused_case(cuda, n, M, C, Mc, times)
    ref_ops, cand_ops = stjoin_ops._flat_operands(*arrs)
    for with_masks in (True, False):
        stats, want = _fused_stats(ref, cand, eps_t)
        before = kernels.LAUNCHES["stjoin_vote_fused"]
        kv, kw = stjoin_ops.stjoin_vote_fused_arrays(
            *arrs, eps_sp, eps_t, delta_t, with_masks=with_masks,
            stats=stats)
        assert kernels.LAUNCHES["stjoin_vote_fused"] == before + 1
        assert stats.tolist() == list(want)
        assert 0 < want[1] < want[0]
        pv, pw = stjoin_vote_fused_ref(*ref_ops, *cand_ops, eps_sp, eps_t,
                                       delta_t, M=M, with_words=with_masks)
        assert torch.equal(kv.view(-1), pv)
        if with_masks:
            assert torch.equal(kw.view(pw.shape), pw)
            assert bool((pw != 0).any())
        else:
            assert kw is None


def _k4_case(cuda, n, M, C, Mc, ms, times="ais"):
    ref, cand, arrs = _fused_case(cuda, n, M, C, Mc, times)
    rng = np.random.default_rng(n)
    rsub = torch.from_numpy(rng.integers(-1, ms, (n, M)).astype(np.int32))
    csub = torch.from_numpy(rng.integers(-1, ms, (C, Mc)).astype(np.int32))
    return ref, cand, arrs, rsub.to(cuda), csub.to(cuda)


def _k4_plain(arrs, rsub, csub, ms, eps, M):
    ref_ops, cand_ops = stjoin_ops._flat_operands(*arrs)
    n, C = rsub.shape[0], csub.shape[0]
    return stjoin_sim_fused_ref(
        *ref_ops, slot_ids(rsub, ms, n * ms).view(-1), *cand_ops,
        slot_ids(csub, ms, C * ms), *eps, M=M, n_src=n * ms, n_dst=C * ms)


@pytest.mark.parametrize("n,M,C,Mc,eps_sp,eps_t,delta_t,times", FUSED_CASES)
def test_k4_matches_plain(cuda, n, M, C, Mc, eps_sp, eps_t, delta_t, times):
    """K4's raw bitwise its plain version; its skip counts equal the plain
    mirror's over every (row, candidate) pair."""
    ms = 4
    ref, cand, arrs, rsub, csub = _k4_case(cuda, n, M, C, Mc, ms, times)
    stats, want = _fused_stats(ref, cand, eps_t)
    before = kernels.LAUNCHES["stjoin_sim_fused"]
    raw = stjoin_ops.stjoin_sim_fused(ref, cand, rsub, csub, ms, eps_sp,
                                      eps_t, delta_t, stats=stats)
    assert kernels.LAUNCHES["stjoin_sim_fused"] == before + 1
    assert stats.tolist() == list(want)
    assert 0 < want[1] < want[0]
    plain = _k4_plain(arrs, rsub, csub, ms, (eps_sp, eps_t, delta_t), M)
    assert torch.equal(raw, plain)
    assert bool((plain > 0).any())


@pytest.mark.parametrize("kernel,M", [("K2", 1608), ("K4", 796)])
def test_k2_k4_longest_rows(cuda, kernel, M):
    """The longest rows K2 (M = 1,608) and K4 (M = 796 at ms = 8) took
    before the time-window sweep still run, bitwise their plain versions
    (the launcher picks a 32-point window)."""
    n, C, Mc, ms = 3, 40, 70, 8
    ref, cand, arrs, rsub, csub = _k4_case(cuda, n, M, C, Mc, ms)
    eps = (20.0, 120.0, 300.0)
    if kernel == "K2":
        kv, kw = stjoin_ops.stjoin_vote_fused_arrays(*arrs, *eps)
        ref_ops, cand_ops = stjoin_ops._flat_operands(*arrs)
        pv, pw = stjoin_vote_fused_ref(*ref_ops, *cand_ops, *eps, M=M)
        assert torch.equal(kv.view(-1), pv)
        assert torch.equal(kw.view(pw.shape), pw)
        assert bool((pv > 0).any())
    else:
        raw = stjoin_ops.stjoin_sim_fused(ref, cand, rsub, csub, ms, *eps)
        plain = _k4_plain(arrs, rsub, csub, ms, eps, M)
        assert torch.equal(raw, plain)
        assert bool((plain > 0).any())


@pytest.mark.parametrize("kernel,M", [("K2", 1700), ("K4", 900)])
def test_k2_k4_refuse_rows_past_shared_memory(cuda, kernel, M):
    """Rows past the longest that fits one block's shared memory with a
    32-point window (K2: 1,652 points, K4: 826 at ms = 8) are refused by
    the launcher (``RuntimeError``) without a launch (only the chunk time
    bounds its sweep would read were built); the card stays usable."""
    ms = 8
    ref, cand, arrs, rsub, csub = _k4_case(cuda, 2, M, 5, 20, ms)
    name = "stjoin_vote_fused" if kernel == "K2" else "stjoin_sim_fused"
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match=name):
        if kernel == "K2":
            stjoin_ops.stjoin_vote_fused_arrays(*arrs, 10.0, 120.0)
        else:
            stjoin_ops.stjoin_sim_fused(ref, cand, rsub, csub, ms, 10.0,
                                        120.0)
    before["chunk_time_bounds"] += 1
    assert kernels.LAUNCHES == before
    torch.cuda.synchronize()


def _panel_stats(tb, sub, ms, eps, p0, Sb, want_skipped, **kw):
    """One panel through the public wrapper with ``stats`` and through a
    prepared sweep: the counts equal the plain mirror's, the two runs are
    bitwise equal; returns ``(fwd, rev, swept, skipped)``."""
    stats = torch.zeros(2, dtype=torch.int64, device=tb.x.device)
    fwd, rev = stjoin_ops.stjoin_sim_panel_fused(
        tb, tb, sub, sub, ms, *eps, p0=p0, panel=Sb, stats=stats, **kw)
    sweep = stjoin_ops.sim_panel_sweep(tb, tb, sub, sub, ms, *eps, **kw)
    swept, skipped = sweep.skip_counts(p0, panel=Sb)
    assert stats.tolist() == [swept, skipped], (p0, stats, swept, skipped)
    again = sweep(p0, panel=Sb)
    assert torch.equal(again[0], fwd) and torch.equal(again[1], rev), p0
    want_skipped.append((swept, skipped))
    return fwd, rev


@pytest.mark.parametrize("n,M,eps_sp,eps_t,delta_t,ms,Sb,times", [
    (10, 40, 15.0, 120.0, 0.0, 4, 8, "ais"),
    (13, 70, 8.0, 120.0, 300.0, 3, 13, "ais"),
    (37, 50, 10.0, 120.0, 0.0, 8, 37, "ais"),
    (37, 50, 10.0, 60.0, 0.0, 3, 37, "grid60"),
    (40, 45, 10.0, 120.0, 0.0, 2, 16, "epoch"),
    (35, 33, 10.0, 120.0, 200.0, 3, 15, "unsorted"),
    (20, 40, 15.0, 1e9, 0.0, 4, 8, "ais"),
    (20, 40, 15.0, 1e-3, 0.0, 4, 8, "grid60"),
    (9, 150, 15.0, 120.0, 0.0, 4, 12, "ais"),
    (6, 700, 15.0, 120.0, 300.0, 2, 4, "ais")])
def test_k7_matches_plain_and_k4(cuda, n, M, eps_sp, eps_t, delta_t, ms, Sb,
                                 times):
    """Every panel: K7's two slabs bitwise equal to its plain version and
    to the K4 kernel's raw rows and transposed columns, its skip counts
    equal to the plain mirror's, two runs bitwise equal.  Sb = 13 with
    ms = 3 and Sb = 37 with ms = 8 split trajectories' slots; ms = 3 with
    Sb = 37 and ms = 2 with Sb = 16 put a panel's candidates across the
    32-candidate tiles.  Times on a 60 s grid with eps_t = 60 (pairs
    exactly eps_t apart), epoch-sized, unsorted; eps_t = 1e9 skips only
    empty chunks, eps_t = 1e-3 most chunks.  M = 150 stages the
    candidates in two windows of 128 points, M = 700 in windows of 64
    (the widest whose shared memory fits)."""
    tb, _ = ais_like(n_vessels=n, max_points=M, seed=n, device=cuda)
    tb = _retime(tb, times, seed=n)
    rng = np.random.default_rng(n)
    sub = torch.from_numpy(rng.integers(-1, ms, (n, M)).astype(np.int32))
    sub = sub.to(cuda)
    eps = (eps_sp, eps_t, delta_t)
    raw = stjoin_ops.stjoin_sim_fused(tb, tb, sub, sub, ms, *eps)
    S = n * ms
    arrs = (tb.x, tb.y, tb.t, tb.valid, tb.traj_id) * 2
    ref_ops, cand_ops = stjoin_ops._flat_operands(*arrs)
    gid = slot_ids(sub, ms, S)
    counts = []
    for p0 in range(0, S, Sb):
        before = kernels.LAUNCHES["stjoin_sim_panel_fused"]
        fwd, rev = _panel_stats(tb, sub, ms, eps, p0, Sb, counts)
        assert kernels.LAUNCHES["stjoin_sim_panel_fused"] == before + 2
        pf, pr = stjoin_sim_panel_fused_ref(
            *ref_ops, gid.view(-1), *cand_ops, gid, *eps, M=M, n_src=S,
            n_dst=S, p0=p0, panel=Sb)
        assert torch.equal(fwd, pf) and torch.equal(rev, pr), p0
        assert torch.equal(fwd, raw[p0:p0 + Sb]), p0
        assert torch.equal(rev, raw.T[p0:p0 + Sb]), p0
    assert bool((raw > 0).any())
    swept, skipped = np.sum(counts, 0)
    if eps_t == 1e9:                 # only chunks or groups of padding
        assert skipped < swept // 2
    elif eps_t == 1e-3:              # groups of 8 points span 7 steps
        assert skipped > 0.7 * swept
    else:
        assert 0 < skipped < swept


@pytest.mark.parametrize("on_cpu", ["batch", "slots", "stats"])
def test_k7_refuses_mixed_devices(cuda, on_cpu):
    """An operand on the CPU beside others on the card is refused before
    any launch (``ValueError``), and the card stays usable; so is a
    ``stats`` tensor off the operands' card."""
    tb, _ = ais_like(n_vessels=6, max_points=20, seed=6, device=cuda)
    sub = torch.zeros((6, 20), dtype=torch.int32, device=cuda)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    if on_cpu == "batch":
        tb = TrajectoryBatch(x=tb.x.cpu(), y=tb.y.cpu(), t=tb.t.cpu(),
                             valid=tb.valid.cpu(), traj_id=tb.traj_id.cpu())
    elif on_cpu == "slots":
        sub = sub.cpu()
    else:
        stats = stats.cpu()
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="devices|stats"):
        stjoin_ops.stjoin_sim_panel_fused(tb, tb, sub, sub, 2, 10.0, 120.0,
                                          0.0, p0=0, panel=4, stats=stats)
    assert kernels.LAUNCHES == before
    torch.cuda.synchronize()


def test_k7_refuses_rows_past_shared_memory(cuda):
    """Rows too long for one block's shared memory (the ``[M][33]`` tiles
    of M = 900 points alone pass the opt-in limit) are refused by the
    launcher (``RuntimeError``) without a launch (only the chunk time
    bounds its sweep would read were built); the card stays usable."""
    tb, _ = ais_like(n_vessels=2, max_points=900, seed=2, device=cuda)
    sub = torch.zeros((2, 900), dtype=torch.int32, device=cuda)
    sweep = stjoin_ops.sim_panel_sweep(tb, tb, sub, sub, 2, 10.0, 120.0)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="stjoin_sim_panel_fused"):
        sweep(0, panel=2)
    before["chunk_time_bounds"] += 1
    assert kernels.LAUNCHES == before
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("S,K,case", [
    (300, 7, "plain"), (5000, 64, "plain"), (5000, 4096, "plain"),
    (3000, 130, "plain"), (1000, 32, "plain"), (700, 1, "plain"),
    (1000, 256, "misaligned"), (1000, 7, "misaligned"),
    (1000, 256, "no_reps"), (1000, 256, "invalid")])
def test_k8_k9_match_plain(cuda, S, K, case):
    """K8 and K9 bitwise their plain versions (K9 also its schedule's
    mirror), one launch each: K from 1 to 4,096 (K % 4 != 0 takes K9's
    scalar groups, K = 32 four rows a warp), lists that are views one
    entry off 16-byte alignment, no representatives, every row
    invalid."""
    rng = np.random.default_rng(S + K)
    ids, sims = _lists(rng, S, K, cuda)
    if case == "misaligned":
        ids = torch.cat([ids.new_zeros(1), ids.flatten()])[1:].view(S, K)
        sims = torch.cat([sims.new_zeros(1), sims.flatten()])[1:].view(S, K)
        assert ids.data_ptr() % 16 and sims.data_ptr() % 16
    rank = torch.from_numpy(rng.permutation(S).astype(np.int32)).to(cuda)
    unres = torch.from_numpy(rng.uniform(size=S) < 0.4).to(cuda)
    rep = ~unres & torch.from_numpy(rng.uniform(size=S) < 0.5).to(cuda)
    if case == "no_reps":
        rep = torch.zeros_like(rep)
    valid = torch.from_numpy(rng.uniform(size=S) < (
        0.0 if case == "invalid" else 0.9)).to(cuda)
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
    mw, ms = topk_claim_max_schedule_ref(ids, sims, rank, rep, valid, 0.4)
    assert torch.equal(kw, mw) and torch.equal(ks, ms)
    if case in ("no_reps", "invalid"):
        assert not bool(kw.any()) and bool((ks == -1).all())
    else:
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
    assert n["sim_row_moments"] == n["stjoin_sim_panel_fused"]
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
# The row moments of alpha (K16, sim_row_moments): bitwise the plain tree.
# ---------------------------------------------------------------------------


def _moments_case(cuda, R, N, seed, wide=False):
    """A sparse ``[R, N]`` float32 matrix on the card (about 30% positive
    entries, exact zeros, 2% negative ones) and row / column masks with
    about 10% false; ``wide`` spreads the positive values over 1e-15 ..
    1e15, so that any other grouping of the additions rounds otherwise."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=cuda)
    vals = u(R, N)
    if wide:
        vals = (vals + 0.5) * 10.0 ** torch.randint(
            -15, 16, (R, N), generator=g, device=cuda).float()
    sim = torch.where(u(R, N) < 0.3, vals, 0.0)
    sim = torch.where(u(R, N) < 0.02, -0.5, sim)
    return sim, u(R) < 0.9, u(N) < 0.9


def _moments_bitwise(got, sim, row_valid, col_valid):
    """``got`` equal to the plain tree's moments on the card and on the
    CPU, bit for bit."""
    for d in (sim.device, "cpu"):
        want = sim_row_moments_ref(sim.to(d), row_valid.to(d),
                                   col_valid.to(d))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("N", [1, 7, 128, 4096, 4097, 32768])
def test_row_moments_match_plain(cuda, N, wide):
    """K16, one launch a call, bitwise the plain tree at row lengths from 1
    to dsc_brest's S: on contiguous rows; on the same rows at a row stride
    that is a multiple of 4 (16-byte loads, the row's last group by
    scalars where N % 4 != 0); with the column mask one byte off its
    alignment (scalar loads)."""
    R = 64 if N <= 4097 else 40
    sim, rv, cv = _moments_case(cuda, R, N, N + wide, wide)
    before = kernels.LAUNCHES["sim_row_moments"]
    got = sim_row_moments(sim, rv, cv)
    assert kernels.LAUNCHES["sim_row_moments"] == before + 1
    _moments_bitwise(got, sim, rv, cv)
    assert int(got[0].sum()) > 0 or not bool(cv.any())
    assert not bool(got[0][~rv].any())
    ld = 4 * (N // 4 + 1)
    buf = torch.full((R, ld), 7.0, device=cuda)
    buf[:, :N] = sim
    mask = torch.zeros(N + 1, dtype=torch.bool, device=cuda)
    mask[1:] = cv
    for args in ((buf[:, :N], rv, cv), (sim, rv, mask[1:])):
        again = sim_row_moments(*args)
        assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert kernels.LAUNCHES["sim_row_moments"] == before + 3


def test_row_moments_panel_and_column_block(cuda):
    """The shapes of K16's other callers: a ``[128, S]`` row panel (the
    top-K sweep) gives the dense call's rows bit for bit; a ``[S, S_loc]``
    column block of the matrix (the multi-device program's, a strided view
    with its slice of ``col_valid``) is bitwise the plain tree of its copy,
    at an aligned and at an odd column offset."""
    S, Sb = 4096, 128
    sim, valid, _ = _moments_case(cuda, S, S, 3, wide=True)
    sim = torch.maximum(sim, sim.T)
    dense = sim_row_moments(sim, valid, valid)
    _moments_bitwise(dense, sim, valid, valid)
    for p0 in (0, 1920, S - Sb):
        panel = sim_row_moments(sim[p0:p0 + Sb], valid[p0:p0 + Sb], valid)
        assert all(torch.equal(a, b[p0:p0 + Sb])
                   for a, b in zip(panel, dense))
    for c0, S_loc in ((S // 2, S // 2), (1, 1023)):
        block = sim[:, c0:c0 + S_loc]
        assert block.stride() == (S, 1)
        got = sim_row_moments(block, valid, valid[c0:c0 + S_loc])
        _moments_bitwise(got, block.contiguous(), valid,
                         valid[c0:c0 + S_loc])


def test_rounds_and_topk_rounds_same_alpha(cuda):
    """``cluster_rounds`` on the dense matrix (K16 over ``[S, S]``) and
    ``cluster_rounds_topk`` on the panel sweep's lists (K16 a panel)
    resolve bit-equal alpha on one batch, from bit-equal moments; the
    plain engine on the card (the plain tree, no launch) resolves the
    same alpha."""
    tb, _ = ais_like(n_vessels=48, max_points=64, n_lanes=8, seed=0,
                     device=cuda)
    p = DSCParams(eps_sp=15.0, eps_t=120.0, w=8, tau=0.4, alpha_sigma=-1.0,
                  k_sigma=-1.0, segmentation="tsa2")
    dense = run_dsc(tb, p, plan=_path_plan("fused"), device=cuda)
    topk = run_dsc(tb, p, plan=_path_plan("fused_topk"), device=cuda)
    moments = sim_row_moments(dense.sim, dense.table.valid,
                              dense.table.valid)
    for m, f in zip(moments, ("degree", "row_sum", "row_sumsq")):
        assert torch.equal(m, getattr(topk.sim_topk, f)), f
    a = cluster_rounds(dense.sim, dense.table, p, use_kernel=True)
    b = cluster_rounds_topk(topk.sim_topk, topk.table, p, use_kernel=True)
    assert torch.equal(a.alpha_used.view(torch.int32),
                       b.alpha_used.view(torch.int32))
    kernels.reset_launch_counts()
    c = cluster_rounds(dense.sim, dense.table, p)
    assert not any(kernels.LAUNCHES.values())
    assert torch.equal(c.alpha_used.view(torch.int32),
                       a.alpha_used.view(torch.int32))
    assert torch.equal(a.alpha_used, dense.result.alpha_used)
    assert int(moments[0].sum()) > 0


# ---------------------------------------------------------------------------
# The pruned kernels K10-K13: each bitwise its dense kernel and its plain
# version, on a lane-sorted batch whose plans skip tiles.
# ---------------------------------------------------------------------------


def _flat(tb):
    return stjoin_ops._flat_operands(*(tb.x, tb.y, tb.t, tb.valid,
                                       tb.traj_id) * 2)


def _join_plan(ref, cand, eps):
    mask, counts, _ = stjoin_ops.plan_join_index(ref, cand, *eps)
    assert 0 < int(mask.sum()) < mask.numel()
    return stjoin_ops._compact(mask, counts, None, "join")


# name: (reference, candidates, whether the plan is the index's own
# conservative plan, so that K10 equals K1)
K10_CASES = {"lanes": (lambda c: (_lanes(c),) * 2, True),
             "windows": (lambda c: (_lanes(c, M=300),) * 2, True),
             "empty_rows": (lambda c: (_lanes(c),) * 2, False)}


@pytest.mark.parametrize("case", sorted(K10_CASES))
def test_k10_matches_k1_and_plain(cuda, case):
    """K10 bitwise its plain version over its plan (and K1 where the plan
    is the index's), its skip counts equal the plain mirror's over the
    plan's kept (block, tile) pairs.  ``windows``: rows of 300 points, so
    the candidates are staged in three windows; ``empty_rows`` blanks
    every third row of the plan (a row of -1 only), so K10 writes (0, -1)
    over whole rows of blocks."""
    make, conservative = K10_CASES[case]
    ref, cand = make(cuda)
    tile_ids = _join_plan(ref, cand, LANE_EPS)
    if not conservative:
        tile_ids[::3] = -1
    ref_ops, cand_ops = stjoin_ops._flat_operands(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id, cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id)
    stats, want = _join_stats(ref, cand, LANE_EPS[1], tile_ids)
    before = kernels.LAUNCHES["stjoin_best_match_pruned"]
    kw, ki = stjoin_ops.stjoin_best_match_pruned(
        *ref_ops, *cand_ops, tile_ids, *LANE_EPS, stats=stats)
    assert kernels.LAUNCHES["stjoin_best_match_pruned"] == before + 1
    assert stats.tolist() == list(want)
    assert 0 < want[1] < want[0]
    w, i = stjoin_pruned_ref(*ref_ops, *cand_ops, tile_ids, *LANE_EPS,
                             bp=stjoin_ops.JOIN_BP, bc=stjoin_ops.JOIN_BC)
    assert torch.equal(kw, w) and torch.equal(ki, i)
    assert bool((i >= 0).any())
    dw, di = stjoin_ops.stjoin_best_match(*ref_ops, *cand_ops, *LANE_EPS)
    assert (torch.equal(kw, dw) and torch.equal(ki, di)) == conservative
    if case == "lanes":              # the batch-level wrapper, its geometry
        k = stjoin_ops.best_match_join_pruned(ref, ref, *LANE_EPS)
        T, M = ref.x.shape
        assert torch.equal(k.best_w.view(T * M, -1), dw)
        assert torch.equal(k.best_idx.view(T * M, -1), di)
        with pytest.raises(ValueError, match="bp=256, bc=8"):
            stjoin_ops.best_match_join_pruned(ref, ref, *LANE_EPS, bp=256,
                                              bc=8)


@pytest.mark.parametrize("fault", ["unsorted", "duplicate", "gap"])
def test_k10_refuses_unordered_plan(cuda, fault):
    """K10 walks each row of its plan in order: a row whose ids are not
    ascending and unique, or with an id after a -1, is refused
    (``ValueError``) before any launch; the card stays usable."""
    tb = _lanes(cuda)
    tile_ids = _join_plan(tb, tb, LANE_EPS)
    row = int(torch.nonzero((tile_ids >= 0).sum(1) >= 2)[0, 0])
    if fault == "unsorted":
        tile_ids[row, :2] = tile_ids[row, :2].flip(0)
    elif fault == "duplicate":
        tile_ids[row, 1] = tile_ids[row, 0]
    else:
        tile_ids[row, 0] = -1
    before = dict(kernels.LAUNCHES)
    ref_ops, cand_ops = _flat(tb)
    with pytest.raises(ValueError, match="ascending"):
        stjoin_ops.stjoin_best_match_pruned(*ref_ops, *cand_ops, tile_ids,
                                            *LANE_EPS)
    assert kernels.LAUNCHES == before
    torch.cuda.synchronize()


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
    T, M = tb.x.shape
    for with_masks in (True, False):
        stats, want = _fused_stats(tb, tb, LANE_EPS[1], plan)
        before = kernels.LAUNCHES["stjoin_vote_fused_pruned"]
        kv, kw = stjoin_ops.stjoin_vote_fused_arrays(
            *arrs, *LANE_EPS, delta_t, tile_ids=plan, with_masks=with_masks,
            stats=stats)
        assert kernels.LAUNCHES["stjoin_vote_fused_pruned"] == before + 1
        assert stats.tolist() == list(want)
        assert want[0] < T * T * (-(-M // 8)) ** 2
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
    stats, want = _fused_stats(tb, tb, LANE_EPS[1], plan)
    before = kernels.LAUNCHES["stjoin_sim_fused_pruned"]
    raw = stjoin_ops.stjoin_sim_fused(tb, tb, sub, sub, ms, *LANE_EPS,
                                      delta_t, tile_ids=plan, stats=stats)
    assert kernels.LAUNCHES["stjoin_sim_fused_pruned"] == before + 1
    assert stats.tolist() == list(want)
    assert want[0] < T * T * (-(-M // 8)) ** 2
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


@pytest.mark.parametrize("ms,Sb,eps_t,delta_t,times", [
    (3, 13, LANE_EPS[1], 0.0, "ais"), (8, 128, LANE_EPS[1], 300.0, "ais"),
    (3, 13, 60.0, 0.0, "grid60"), (2, 24, LANE_EPS[1], 0.0, "unsorted"),
    (8, 128, 1e9, 0.0, "epoch"), (3, 39, 1e-3, 0.0, "grid60")])
def test_k13_matches_k7_and_plain(cuda, ms, Sb, eps_t, delta_t, times):
    """Every panel: K13's slabs bitwise K7's and its plain version's, its
    skip counts equal to the plain mirror's over its planned pairs, two
    runs bitwise equal; Sb = 13 with ms = 3 splits trajectories' slots,
    and panels cross tiles.  Adversarial times and eps_t as for K7."""
    tb = _retime(_lanes(cuda), times)
    eps = (LANE_EPS[0], eps_t, delta_t)
    plan = stjoin_ops.plan_fused_tiles(*(tb.x, tb.y, tb.t, tb.valid) * 2,
                                       *eps[:2])
    rng = np.random.default_rng(ms)
    T, M = tb.x.shape
    sub = torch.from_numpy(rng.integers(-1, ms, (T, M)).astype(np.int32))
    sub = sub.to(cuda)
    S = T * ms
    ref_ops, cand_ops = _flat(tb)
    gid = slot_ids(sub, ms, S)
    hit = False
    counts = []
    for p0 in range(0, S - Sb + 1, Sb):
        before = kernels.LAUNCHES["stjoin_sim_panel_fused_pruned"]
        fwd, rev = _panel_stats(tb, sub, ms, eps, p0, Sb, counts,
                                tile_ids=plan)
        assert kernels.LAUNCHES["stjoin_sim_panel_fused_pruned"] \
            == before + 2
        df, dr = stjoin_ops.stjoin_sim_panel_fused(
            tb, tb, sub, sub, ms, *eps, p0=p0, panel=Sb)
        pf, pr = stjoin_sim_panel_fused_ref(
            *ref_ops, gid.view(-1), *cand_ops, gid, *eps, M=M, n_src=S,
            n_dst=S, p0=p0, panel=Sb, tiles=(plan.tile_ids, M, plan.bc))
        assert torch.equal(fwd, df) and torch.equal(rev, dr), p0
        assert torch.equal(fwd, pf) and torch.equal(rev, pr), p0
        hit |= bool((pf > 0).any())
    assert hit
    swept, skipped = np.sum(counts, 0)
    assert skipped < swept
    if eps_t != 1e9 and times != "unsorted":    # unsorted: chunks span all
        assert skipped > 0


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
    (20, 40, 1, 1.0), (9, 300, 70, 0.8), (5, 16, 16, 0.0),
    (13, 1, 1, 1.0), (21, 33, 128, 0.9), (22, 128, 33, 0.9),
    (11, 129, 128, 0.9), (10, 128, 129, 0.9), (7, 300, 129, 0.9),
    (6, 129, 300, 0.9), (3, 1, 300, 1.0), (5, 300, 1, 1.0),
    (2, 129, 7300, 0.9), (3, 200, 1500, 0.9), (2, 129, 1536, 0.9)])
def test_k14_matches_plain(cuda, B, N, M, p_valid):
    """K14 bitwise its sheared plain twin and the row scan, and on the
    transposed pairs; N != M, N = 1, M = 1, one strip of rows (N <= 128)
    and more (N = 129, 300: the carried row), a B not a multiple of the
    block's pairs, all-invalid pairs (score 0), carried rows under 48 KB
    that take the block past it beside the static rings (M = 1500, 1536),
    and a pair whose carried rows do not fit shared memory (N = 129,
    M = 7300: global scratch)."""
    ops, eps_sp, eps_t = _lcss_pairs(cuda, B, N, M, B + N + M, p_valid)
    before = kernels.LAUNCHES["lcss_wavefront"]
    got = lcss_ops.lcss_wavefront(*ops, eps_sp, eps_t)
    assert kernels.LAUNCHES["lcss_wavefront"] == before + 1
    twin = lcss_ref.lcss_wavefront_ref(lcss_ref.shear_weights(*ops, eps_sp,
                                                              eps_t))
    assert torch.equal(got, twin)
    assert torch.equal(got, lcss_ref.lcss_ref(*ops, eps_sp, eps_t))
    if M == 7300:
        assert lcss_ops.smem_bytes(N, M) > kernels.smem_optin(0)
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


def _k15_check(q, k, v, qp, kp, window=None, prefix=None, max_kv=None,
               softcap=None):
    """One K15 launch against the plain version within
    ``kernel_tolerance``; its skipped tiles against the mirror of the tile
    test.  Returns the output and the plan."""
    args = (attn_ops.HUGE if window is None else window,
            0 if prefix is None else prefix,
            attn_ops.HUGE if max_kv is None else max_kv)
    stats = torch.zeros(2, dtype=torch.int32, device=q.device)
    before = kernels.LAUNCHES["flash_attention_fwd"]
    got = attn_ops.flash_attention_fwd(q, k, v, qp, kp, *args,
                                       softcap=softcap, stats=stats)
    assert kernels.LAUNCHES["flash_attention_fwd"] == before + 1
    want = flash_attention_ref(q, k, v, qp, kp, *args, softcap=softcap)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = kernel_tolerance(q, k, v, qp, kp, *args, softcap, want)
    used = float(((got.float() - want.float()).abs() / tol).max())
    assert used <= 1.0, f"{used:.3g} of the tolerance"
    B, Lq, KV, G, hd = q.shape
    plan = attn_ops.plan_for(q, k, v)
    cls = tile_class_ref(qp, kp, *args, G=G, rows=plan.rows, keys=plan.keys)
    assert stats.tolist() == [cls.numel() * B * KV,
                              int((cls == 0).sum()) * B * KV]
    return got, plan


def _k15_inputs(cuda, dtype, B, Lq, M, KV, G, hd, qp, kp, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, Lq, KV, G, hd)) * hd ** -0.5
    k, v = (rng.normal(0, 1, (B, M, KV, hd)) for _ in range(2))
    qkv = [torch.from_numpy(a.astype(np.float32)).to(dtype).to(cuda)
           for a in (q, k, v)]
    pos = [torch.from_numpy(np.asarray(p, np.int32)).to(cuda)
           for p in (qp, kp)]
    return qkv, pos


def _edge(name, rng):
    """(Lq, M, positions, mask) of each tile-skip edge."""
    if name == "mixed_block":        # queries 0-9 keep no key
        return 70, 130, np.arange(70), np.arange(130) + 10, dict(window=8)
    if name == "descending_kv":
        return 90, 150, np.arange(90) + 60, np.arange(150)[::-1].copy(), \
            dict(window=40)
    if name == "shuffled_kv":
        return 90, 150, np.arange(90) + 60, rng.permutation(150), \
            dict(window=40, softcap=30.0)
    if name == "prefix_across_tiles":
        return 200, 200, np.arange(200), np.arange(200), dict(prefix=100)
    if name == "window_below_tile":
        return 150, 150, np.arange(150), np.arange(150), dict(window=5)
    if name == "max_kv_in_tile":
        return 100, 150, np.arange(100) + 50, np.arange(150), \
            dict(max_kv=37)
    return 77, 97, np.arange(77) + 20, np.arange(97), dict()  # ragged M


K15_EDGES = ("mixed_block", "descending_kv", "shuffled_kv",
             "prefix_across_tiles", "window_below_tile", "max_kv_in_tile",
             "ragged_m")


def _no_split(monkeypatch):
    """Plan as for a card of one SM: no key split at these small shapes."""
    monkeypatch.setattr(attn_ops, "_sm_count", lambda index: 1)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", K15_EDGES)
def test_k15_tile_skip_edges(cuda, monkeypatch, edge, dtype, split):
    """Skipping tiles never changes a row beyond ``kernel_tolerance``: a
    block mixing fully masked rows and rows that keep keys, unsorted key
    positions, a prefix across tiles, a window below one tile, ``max_kv``
    inside a tile, M not a multiple of any tile; with the keys split and
    merged (the plan's choice here) and in one pass."""
    if not split:
        _no_split(monkeypatch)
    Lq, M, qp, kp, mask = _edge(edge, np.random.default_rng(7))
    (q, k, v), (qp, kp) = _k15_inputs(cuda, dtype, 2, Lq, M, 2, 3, 64, qp,
                                      kp)
    got, plan = _k15_check(q, k, v, qp, kp, **mask)
    assert plan.path == ("bf16_mma" if dtype == torch.bfloat16
                         else "f32_tiled")
    assert (plan.nsplit > 1) == split
    if edge == "mixed_block":
        mean = v.float().mean(dim=1)[:, None, :, None, :].expand(q.shape)
        torch.testing.assert_close(got[:, :10].float(), mean[:, :10],
                                   **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,max_kv", [(1, None), (33, None), (1000, None),
                                      (1000, 700), (9000, None),
                                      (9000, 6000)])
def test_k15_decode_split(cuda, M, max_kv, dtype):
    """Lq = 1 and Lq * G below one row block: the keys split across blocks
    and merged (every M past one tile), with and without ``max_kv``."""
    qpos = [M - 1 if max_kv is None else max_kv]
    (q, k, v), (qp, kp) = _k15_inputs(cuda, dtype, 1, 1, M, 4, 2, 256,
                                      qpos, np.arange(M), seed=M)
    _, plan = _k15_check(q, k, v, qp, kp, max_kv=max_kv, softcap=50.0)
    assert (plan.nsplit > 1) == (M > plan.keys)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 128, 256, 320])
def test_k15_head_dims(cuda, monkeypatch, hd, dtype, split):
    """Every head dim: the fast paths up to 256, the general path above;
    split and in one pass."""
    if not split:
        _no_split(monkeypatch)
    (q, k, v), (qp, kp) = _k15_inputs(cuda, dtype, 1, 100, 100, 2, 2, hd,
                                      np.arange(100), np.arange(100),
                                      seed=hd)
    _, plan = _k15_check(q, k, v, qp, kp, window=30)
    assert (plan.path == "general") == (hd > 256)
    assert (plan.nsplit > 1) == split


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k15_many_kv_heads(cuda, dtype):
    """B * KV = 65537, past the 65535 of a grid's y dimension."""
    (q, k, v), (qp, kp) = _k15_inputs(cuda, dtype, 65537, 2, 3, 1, 1, 8,
                                      [1, 2], [0, 1, 2])
    _k15_check(q, k, v, qp, kp)


@pytest.mark.parametrize("case", ["bf16_prefill", "f32_prefill",
                                  "bf16_decode", "general"])
def test_k15_bitwise_repeatable(cuda, case):
    """Two identical K15 calls give equal bits (the split merge runs in a
    fixed order, no float atomics)."""
    dtype = torch.float32 if case.startswith("f32") else torch.bfloat16
    Lq, M, hd = {"bf16_decode": (1, 5000, 256), "general": (60, 200, 320)
                 }.get(case, (300, 300, 64))
    (q, k, v), (qp, kp) = _k15_inputs(cuda, dtype, 1, Lq, M, 2, 3, hd,
                                      np.arange(M - Lq, M), np.arange(M))
    a = attn_ops.flash_attention(q, k, v, qp, kp, softcap=50.0)
    b = attn_ops.flash_attention(q, k, v, qp, kp, softcap=50.0)
    assert torch.equal(a, b)


@pytest.mark.parametrize("B,N,M", [(2, 4300, 4300), (3, 5000, 300),
                                   (2, 300, 8000)])
def test_k14_long_pairs(cuda, B, N, M):
    """K14 bitwise its sheared twin and the row scan for long pairs: many
    strips of rows, their carried rows in shared memory and, at M = 8000,
    past its limit (a global scratch)."""
    ops, eps_sp, eps_t = _lcss_pairs(cuda, B, N, M, N + M)
    got = lcss_ops.lcss_wavefront(*ops, eps_sp, eps_t)
    assert torch.equal(got, lcss_ref.lcss_ref(*ops, eps_sp, eps_t))
    twin = lcss_ref.lcss_wavefront_ref(lcss_ref.shear_weights(*ops, eps_sp,
                                                              eps_t))
    assert torch.equal(got, twin)
    assert bool((got[:, 1] > 0).all())


def _wide_candidates(cuda, C=32 * 65536 + 1, n_ref=5):
    """One reference trajectory against C one-point candidates:
    ceil(C / 32) = 65,537 candidate tiles."""
    rng = np.random.default_rng(C)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(cuda)
    ref = TrajectoryBatch(x=f(rng.uniform(0, 5, (1, n_ref))),
                          y=f(rng.uniform(0, 5, (1, n_ref))),
                          t=f(np.sort(rng.uniform(0, 50, (1, n_ref)), 1)),
                          valid=torch.ones((1, n_ref), dtype=torch.bool,
                                           device=cuda),
                          traj_id=torch.tensor([C], dtype=torch.int32,
                                               device=cuda))
    cand = TrajectoryBatch(x=f(rng.uniform(0, 5, (C, 1))),
                           y=f(rng.uniform(0, 5, (C, 1))),
                           t=f(rng.uniform(0, 50, (C, 1))),
                           valid=torch.from_numpy(rng.uniform(size=(C, 1))
                                                  < 0.9).to(cuda),
                           traj_id=torch.arange(C, dtype=torch.int32,
                                                device=cuda))
    return ref, cand


def test_k1_k4_wide_candidate_grid(cuda):
    """K1 and K4 bitwise their plain versions with ceil(C / 32) = 65,537
    candidate tiles."""
    ref, cand = _wide_candidates(cuda)
    arrs = (ref.x, ref.y, ref.t, ref.valid, ref.traj_id, cand.x, cand.y,
            cand.t, cand.valid, cand.traj_id)
    ref_ops, cand_ops = stjoin_ops._flat_operands(*arrs)
    w, i = stjoin_ops.stjoin_best_match(*ref_ops, *cand_ops, 0.5, 5.0)
    pw, pi = stjoin_ref(*ref_ops, *cand_ops, 0.5, 5.0)
    assert torch.equal(w, pw) and torch.equal(i, pi)
    assert bool((pi[:, -1000:] >= 0).any())
    ms, C, M = 2, cand.num_trajs, ref.max_points
    rsub = torch.tensor([[0, 0, 1, 1, -1]], dtype=torch.int32, device=cuda)
    csub = torch.zeros((C, 1), dtype=torch.int32, device=cuda)
    raw = stjoin_ops.stjoin_sim_fused(ref, cand, rsub, csub, ms, 0.5, 5.0)
    plain = stjoin_sim_fused_ref(
        *ref_ops, slot_ids(rsub, ms, ms).view(-1), *cand_ops,
        slot_ids(csub, ms, C * ms), 0.5, 5.0, 0.0, M=M, n_src=ms,
        n_dst=C * ms)
    assert torch.equal(raw, plain)
    assert bool((plain[:, -2000:] > 0).any())


# ---------------------------------------------------------------------------
# The resilient runner, the streaming service and the checkpoint store on
# the card
# ---------------------------------------------------------------------------


def _fig1_case(cuda):
    tb, _ = figure1_scenario(n_per_route=4, points_per_leg=24, seed=0,
                             device=cuda)
    return tb, DSCParams(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
                         alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")


@pytest.mark.parametrize("path", ["fused_topk", "materialize"])
def test_resilient_crash_resume_on_card(cuda, path, tmp_path):
    """The kernel plan through the resilient runner: a crash at the cluster
    stage, then a resume, gives ``run_dsc``'s output bit for bit; the
    resumed run launches only the similarity and clustering kernels (the
    top-K widen re-runs similarity from the segment checkpoint)."""
    from repro_torch.run import FaultPlan, InjectedCrash, run_resilient
    tb, params = _fig1_case(cuda)
    plan = _path_plan(path, sim_topk=2 if path == "fused_topk" else None)
    want = run_dsc(tb, params, plan=plan, device=cuda)
    with pytest.raises(InjectedCrash):
        run_resilient(tb, params, plan=plan, checkpoint_dir=tmp_path,
                      fault_plan=FaultPlan(crash_at="cluster"))
    kernels.reset_launch_counts()
    res = run_resilient(tb, params, plan=plan, checkpoint_dir=tmp_path)
    ran = {k for k, n in kernels.LAUNCHES.items() if n}
    assert res.resumed_from == 3
    assert res.widen_count == want.dispatches - 1
    for f in ("member_of", "member_sim", "is_rep", "is_outlier",
              "alpha_used", "k_used"):
        assert torch.equal(getattr(res.output.result, f),
                           getattr(want.result, f)), f
    assert torch.equal(res.output.sscr, want.sscr)
    if path == "fused_topk":
        assert ran == {"chunk_time_bounds", "stjoin_sim_panel_fused",
                       "sim_row_moments", "topk_round_scan",
                       "topk_claim_max"}
        for f in ("ids", "sims", "spill"):
            assert torch.equal(getattr(res.output.sim_topk, f),
                               getattr(want.sim_topk, f)), f
    else:
        assert ran == {"sim_row_moments", "round_scan", "claim_max"}


def _stream_case(n=24, M=24, batch_size=96, segmentation="tsa1"):
    from repro_torch.data.synthetic import (default_dsc_params_for,
                                            stream_records)
    from repro_torch.stream import StreamConfig
    tb, _ = ais_like(n_vessels=n, max_points=M, seed=3, device="cpu")
    diam, mean_dt = default_dsc_params_for(tb)
    cfg = StreamConfig(t_cap=n, m_cap=M, eps_sp=0.15 * diam, eps_t=mean_dt,
                       alpha_abs=0.05, k_abs=0.0,
                       allowed_lateness=2 * mean_dt, horizon=1e9, k=8, w=4,
                       max_subs=4, segmentation=segmentation)
    return cfg, stream_records(tb, batch_size=batch_size)


@pytest.mark.parametrize("segmentation", ["tsa1", "tsa2"])
def test_stream_on_card_matches_kernel_plan_oracle(cuda, monkeypatch,
                                                   segmentation):
    """The service's standing lists, spill and labels on the card equal
    ``run_dsc`` with the materialize top-K kernel plan over the same
    window, bitwise, at every advance; its cube equals K1's full join of
    the window.  Every advance launches K1 and K9 (and K3 under TSA2), the
    run K8.  Delta-join and fresh-block chunks of a few rows."""
    import repro_torch.stream.driver as drv_mod
    from repro_torch.serve.stream import StreamService
    monkeypatch.setattr(drv_mod, "JOIN_ELEMENTS", 24 * 24 * 5)
    monkeypatch.setattr(drv_mod, "FRESH_ELEMENTS", 4 * 96 * 3)
    cfg, batches = _stream_case(segmentation=segmentation)
    svc = StreamService(cfg, device=cuda)
    K = cfg.k
    scans = 0
    for recs in batches:
        svc.driver.submit(recs)
        kernels.reset_launch_counts()
        svc.driver.advance()
        assert kernels.LAUNCHES["stjoin_best_match"] > 0
        assert kernels.LAUNCHES["topk_claim_max"] > 0
        assert (kernels.LAUNCHES["jaccard_window"] > 0) == (
            segmentation == "tsa2")
        scans += kernels.LAUNCHES["topk_round_scan"]
        d = svc.driver
        win = d.window_batch()
        out = run_dsc(win, cfg.params, plan=_path_plan("materialize_topk",
                                                       sim_topk=K),
                      on_overflow="degrade", device=cuda)
        assert torch.equal(out.sim_topk.ids, d.standing_ids[:, :K])
        assert torch.equal(out.sim_topk.sims, d.standing_sims[:, :K])
        assert torch.equal(out.sim_topk.spill, d.standing_sims[:, K])
        for f in ("member_of", "member_sim", "is_rep", "is_outlier"):
            assert torch.equal(getattr(out.result, f), getattr(d, f)), f
        full = best_match_join_kernel(win, win, cfg.eps_sp, cfg.eps_t)
        assert torch.equal(full.best_w, d.cube_w)
        assert torch.equal(full.best_idx, d.cube_idx)
    assert scans > 0
    assert svc.accounting()["balanced"]


def test_stream_k1_delta_join_bitwise_masked_plain_join(cuda):
    """One advance's delta join through K1 equals K1's plain twin under
    the rows' bbox pair mask on the dirty rows, both directions, bitwise."""
    from repro_torch.index.grid import exact_pair_mask
    from repro_torch.stream import StreamDriver
    from repro_torch.kernels.stjoin.ops import _flat_operands
    cfg, batches = _stream_case()
    d = StreamDriver(cfg, device=cuda)
    for recs in batches[:3]:
        d.submit(recs)
        d.advance()
    win = d.window_batch()
    rows = np.arange(0, cfg.t_cap, 2)
    mask = exact_pair_mask(d._boxes(rows), d._boxes(), np.float32(cfg.eps_sp),
                           np.float32(cfg.eps_t))
    r = torch.from_numpy(rows).to(cuda)
    sub = TrajectoryBatch(x=win.x[r], y=win.y[r], t=win.t[r],
                          valid=win.valid[r], traj_id=win.traj_id[r])
    M = cfg.m_cap
    for ref, cand, m, got in (
            (sub, win, mask, (d.cube_w[r], d.cube_idx[r])),
            (win, sub, mask.T, (d.cube_w[:, :, r], d.cube_idx[:, :, r]))):
        ops = _flat_operands(ref.x, ref.y, ref.t, ref.valid, ref.traj_id,
                             cand.x, cand.y, cand.t, cand.valid,
                             cand.traj_id)
        pm = m.repeat_interleave(M, dim=0)
        w, i = stjoin_ref(*ops[0], *ops[1], cfg.eps_sp, cfg.eps_t,
                          pair_mask=pm)
        assert torch.equal(w.view(got[0].shape), got[0])
        assert torch.equal(i.view(got[1].shape), got[1])


def test_checkpoint_of_card_tensors(cuda, tmp_path):
    """Card tensors saved (async: copied to the host before the call
    returns) and restored onto the card, bitwise; the flat restore reads
    host arrays."""
    from repro_torch.checkpoint import CheckpointManager
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.rand((64, 33), device=cuda, generator=g),
            "n": {"i": torch.randint(-9, 9, (7,), device=cuda,
                                     dtype=torch.int32, generator=g),
                  "b": torch.rand((5,), device=cuda, generator=g) > 0.5}}
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(1, tree)
    want = {"w": tree["w"].clone(), "i": tree["n"]["i"].clone()}
    tree["w"].zero_()
    back, step = mgr.restore({"w": tree["w"], "n": tree["n"]})
    assert step == 1 and back["w"].is_cuda
    assert torch.equal(back["w"], want["w"])
    assert torch.equal(back["n"]["i"], want["i"])
    assert torch.equal(back["n"]["b"], tree["n"]["b"])
    flat, _ = mgr.restore_flat(1)
    assert np.array_equal(flat["n/i"], want["i"].cpu().numpy())


# ---------------------------------------------------------------------------
# The multi-device program: a (2, 2) mesh of gloo ranks sharing the card
# ---------------------------------------------------------------------------

# the kernels each distributed path launches on every rank
DIST_KERNELS = {
    "fused_topk": {"chunk_time_bounds", "stjoin_vote_fused",
                   "stjoin_sim_fused", "jaccard_window", "sim_row_moments",
                   "topk_round_scan", "topk_claim_max"},
    "materialize": {"chunk_time_bounds", "stjoin_best_match",
                    "jaccard_window", "sim_row_moments", "round_scan",
                    "claim_max"},
}
DIST_LABELS = ("member_of", "member_sim", "is_rep", "is_outlier")


def _dist_rank(n_vessels):
    """One rank of the card tests' mesh: the fused top-K kernel plan, its
    ring twin, the materialize kernel plan (K1) and the plain plan, each
    with its launches."""
    from repro_torch.core.distributed import run_dsc_distributed
    from repro_torch.core.partitioning import partition_batch
    from repro_torch.distributed.mesh import Mesh
    batch, _ = ais_like(n_vessels=n_vessels, max_points=128, n_lanes=8,
                        seed=0, device="cpu")
    params = DSCParams(eps_sp=17.0, eps_t=60.0, w=20, tau=0.4,
                       alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")
    parts = partition_batch(batch, 2)
    mesh = Mesh((2, 2), "gloo", "cuda")
    plans = {"fused_topk": _path_plan("fused_topk", sim_topk=32),
             "ring": _path_plan("fused_topk", sim_topk=32,
                                halo_stream="ring", sim_exchange="ring"),
             "materialize": _path_plan("materialize"),
             "plain": EnginePlan(sim_mode="topk", sim_topk=32)}
    out = {}
    for name, plan in plans.items():
        kernels.reset_launch_counts()
        o = run_dsc_distributed(parts, params, mesh, plan=plan,
                                on_overflow="widen")
        out[name] = ({f: getattr(o.result, f) for f in DIST_LABELS},
                     {k for k, v in kernels.LAUNCHES.items() if v > 0},
                     o.vote.is_cuda)
    return out


def test_distributed_kernel_plan_matches_plain_on_card(cuda):
    """Mesh (2, 2) on the card at T = 512 (dsc_brest's generator, TSA2):
    the fused top-K kernel plan launches exactly its kernels on every
    rank, its labels equal the plain plan's on the card and the
    materialize kernel plan's (K1, K5, K6), its ring twin is bitwise, and
    every rank assembles the same output."""
    from repro_torch.distributed.mesh import Mesh, spawn
    ranks = spawn(_dist_rank, Mesh((2, 2), "gloo", "cuda"), 512,
                  timeout=600)
    first = ranks[0]
    for r, res in enumerate(ranks):
        assert res["fused_topk"][1] == DIST_KERNELS["fused_topk"], r
        assert res["ring"][1] == DIST_KERNELS["fused_topk"], r
        assert res["materialize"][1] == DIST_KERNELS["materialize"], r
        assert res["plain"][1] == set(), r
        assert res["fused_topk"][2], r
        for name in res:
            for f in DIST_LABELS:
                assert torch.equal(res[name][0][f], first[name][0][f])
    got = first["fused_topk"][0]
    assert int(got["is_rep"].sum()) >= 1
    for f in DIST_LABELS:
        assert torch.equal(first["ring"][0][f], got[f]), f
    for f in ("member_of", "is_rep", "is_outlier"):
        assert torch.equal(first["plain"][0][f], got[f]), f
        assert torch.equal(first["materialize"][0][f], got[f]), f


def test_mesh_refuses_nccl_with_too_few_cards(cuda):
    """nccl needs one card per rank: a mesh larger than the visible cards
    raises before any rank starts."""
    from repro_torch.distributed.mesh import Mesh
    mesh = Mesh((torch.cuda.device_count() + 1, 1), "nccl", "cuda")
    with pytest.raises(RuntimeError, match="one card per rank"):
        mesh.rank_device(0)


def test_distributed_resilient_crash_resume_on_card(cuda, tmp_path):
    """Mesh (2, 1) of gloo ranks on the card at fig1 size, the fused
    top-K kernel plan from K = 4 with widen: a crash at cluster comes back
    as ``InjectedCrash`` from the runner's own spawn, and the resume is
    bitwise the straight run, its output on the card."""
    from repro_torch.core.partitioning import partition_batch
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.run import (FaultPlan, InjectedCrash,
                                 run_resilient_distributed)
    batch = figure1_scenario(n_per_route=4, points_per_leg=24, seed=0,
                             device="cpu")[0]
    params = DSCParams(eps_sp=0.42, eps_t=1.0, delta_t=0.0, w=6, tau=0.15,
                       alpha_sigma=-1.0, k_sigma=-1.0, segmentation="tsa2")
    parts = partition_batch(batch, 2)
    mesh = Mesh((2, 1), "gloo", "cuda")
    kw = dict(plan=_path_plan("fused_topk", sim_topk=4), on_overflow="widen")
    with pytest.raises(InjectedCrash, match="'cluster'"):
        run_resilient_distributed(parts, params, mesh, checkpoint_dir=tmp_path,
                                  fault_plan=FaultPlan(crash_at="cluster"),
                                  **kw)
    res = run_resilient_distributed(parts, params, mesh,
                                    checkpoint_dir=tmp_path, **kw)
    want = run_resilient_distributed(parts, params, mesh, **kw)
    assert res.resumed_from == 3 and res.widen_count == want.widen_count
    assert res.output.vote.is_cuda
    for f in DIST_LABELS:
        assert torch.equal(getattr(res.output.result, f),
                           getattr(want.output.result, f)), f
    for f in ("vote", "active", "sim_diag"):
        assert torch.equal(getattr(res.output, f), getattr(want.output, f)), f
    assert (res.sscr, res.rmse) == (want.sscr, want.rmse)
    assert int(want.output.result.is_rep.sum()) >= 1


def test_tune_cluster_tiles_kernel_candidates_on_card(cuda):
    """The autotuner's cluster sweep on the card: candidate 0 the plain
    round engine, candidates 1-5 K5 / K6, every one bitwise the plain
    oracle on all six result fields, the kernels launched."""
    from repro_torch.tune.autotune import tune_cluster_tiles
    tb, _ = ais_like(n_vessels=512, max_points=64, seed=3, device=cuda)
    diam, mean_dt = default_dsc_params_for(tb)
    params = DSCParams(eps_sp=0.15 * diam, eps_t=mean_dt, delta_t=0.0,
                       w=12, tau=0.4, alpha_sigma=-1.0, k_sigma=-1.0)
    out = run_dsc(tb, params, plan=_path_plan("fused"), device=cuda)
    kernels.reset_launch_counts()
    res = tune_cluster_tiles(out.sim, out.table, params, device=cuda)
    assert len(res.candidates) == 6 and res.backend == "gpu"
    assert all(c.verified for c in res.candidates), \
        [c.note for c in res.candidates]
    assert not res.candidates[0].plan.cluster_use_kernel
    assert all(c.plan.cluster_use_kernel for c in res.candidates[1:])
    assert all(c.peak_buffer_bytes is not None and c.peak_buffer_bytes >= 0
               for c in res.candidates)
    assert kernels.LAUNCHES["round_scan"] > 0
    assert kernels.LAUNCHES["claim_max"] > 0


# ----------------------------- the LM serving path ---------------------------
# bf16 ulps of the largest value compared, card against the CPU (cuBLAS and
# the CPU's GEMMs sum in other orders; a few one-ulp roundings add up
# through the layers); tokens follow the margin rule at 4 ulps


def _ulps(want, ulps):
    import math
    top = float(want.detach().float().abs().max())
    return ulps * 2.0 ** (math.floor(math.log2(top)) - 7) if top else 0.0


def _lm(arch, seed, cuda):
    import copy
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.models import transformer as tf
    cfg = reduced_config(get_arch(arch))
    cpu = tf.init_model(cfg, generator=torch.Generator().manual_seed(seed),
                        device="cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(cuda)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2-moe-a2.7b",
                                  "rwkv6-1.6b", "zamba2-1.2b",
                                  "paligemma-3b", "musicgen-large"])
def test_lm_forward_card_matches_cpu(cuda, arch):
    """One reduced architecture of each family: the full forward's logits
    and a prefill's caches on the card within 8 bf16 ulps of the CPU's,
    no custom kernel launched (the reference's attention is plain XLA)."""
    from repro_torch.models import transformer as tf
    cfg, cpu, card = _lm(arch, 0, cuda)
    rng = np.random.default_rng(0)
    shape = (2, cfg.n_codebooks, 10) if cfg.family == "audio" else (2, 10)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                           .astype(np.int32))
    fe = None
    if cfg.family == "vlm":
        fe = torch.from_numpy(rng.normal(0, 1, (2, cfg.vision_tokens,
                                                cfg.d_vision))
                              .astype(np.float32))
    n = 10 + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    kernels.reset_launch_counts()
    with torch.no_grad():
        outs = []
        for p, d in ((card, cuda), (cpu, torch.device("cpu"))):
            cache = tf.init_cache(cfg, 2, n, device=d)
            logits, _, cache = tf.forward(
                p, tok.to(d), cfg, cache=cache, cache_index=0,
                frontend_inputs=None if fe is None else fe.to(d))
            outs.append((logits, cache))
    assert not any(kernels.LAUNCHES.values())
    (gl, gc), (cl, cc) = outs
    assert gl.is_cuda and bool(torch.isfinite(gl).all())
    torch.testing.assert_close(gl.cpu(), cl, rtol=0, atol=_ulps(cl, 8))
    for k in cc:
        torch.testing.assert_close(gc[k].cpu().float(), cc[k].float(),
                                   rtol=0, atol=_ulps(cc[k], 8))


def _engine_run(mod, params, cfg, monkeypatch=None):
    steps = []
    if monkeypatch is not None:
        for name in ("prefill_step", "decode_step"):
            real = getattr(mod, name)

            def rec(*a, _real=real, **kw):
                logits, cache = _real(*a, **kw)
                steps.append(logits.float().cpu())
                return logits, cache
            monkeypatch.setattr(mod, name, rec)
    eng = mod.ServeEngine(params, cfg, n_slots=3, max_len=48)
    rng = np.random.default_rng(0)
    for u in range(7):
        eng.submit(mod.Request(uid=u, prompt=rng.integers(
            0, 256, int(rng.integers(6, 13))).astype(np.int32), max_new=5))
    return eng, {r.uid: (len(r.prompt), r.out) for r in eng.run()}, steps


def test_serve_engine_card_matches_cpu(cuda, monkeypatch):
    """``ServeEngine`` on the card against the same engine on the CPU
    (reduced smollm-360m, 7 requests in 3 slots): equal counters, and
    each request's tokens equal before its first step whose CPU top-1 /
    top-2 gap is within 4 ulps (the margin rule)."""
    from repro_torch.serve import engine as teng
    cfg, cpu, card = _lm("smollm-360m", 0, cuda)
    ceng, cout, steps = _engine_run(teng, cpu, cfg, monkeypatch)
    monkeypatch.undo()
    geng, gout, _ = _engine_run(teng, card, cfg)
    assert geng.device.type == "cuda"
    for f in ("prefill_calls", "decode_steps", "padding_waste"):
        assert getattr(geng, f) == getattr(ceng, f), f
    order = sorted(cout, key=lambda u: cout[u][0])
    sure = 0
    for w in range(3):
        for slot, uid in enumerate(order[3 * w:3 * w + 3]):
            for t in range(5):
                row = steps[5 * w + t][slot]
                top = torch.topk(row, 2).values
                if float(top[0] - top[1]) <= _ulps(row, 4):
                    break
                assert gout[uid][1][t] == cout[uid][1][t], (uid, t)
                sure += 1
    assert sure >= 10


def test_serve_launcher_on_card(cuda, caplog):
    """The launcher with ``--device cuda`` serves what ``--device cpu``
    serves: the same requests, token counts and counters."""
    import logging
    from repro_torch.launch import serve as launcher
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        g = launcher.main(["--arch", "smollm-360m", "--device", "cuda"])
        c = launcher.main(["--arch", "smollm-360m", "--device", "cpu"])
    assert [len(r.out) for r in g] == [len(r.out) for r in c]
    assert [r.uid for r in g] == [r.uid for r in c]
    lines = [r.getMessage().split("; ", 1)[1] for r in caplog.records
             if "served" in r.getMessage()]
    assert len(lines) == 2 and lines[0] == lines[1]


# ----------------------------- the LM training path --------------------------
# card against the CPU with tests/test_torch_train.py's bounds (bf16
# roundings that fall the other way: the loss within 2**-9, the grad norm
# within 2**-6 relative, moments within 10% relative L2 per leaf above
# 1/256 of the largest leaf norm)

def _train_inputs(cfg, seed):
    from repro_torch.data.pipeline import TokenPipeline
    b = TokenPipeline(cfg, 2, 32, seed=seed).batch_at(0)
    fe = b.get("frontend")
    return (torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"]),
            None if fe is None else torch.from_numpy(fe))


def _rel_l2(got, want, floor):
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return float((g - w).norm()) / max(float(w.norm()), floor)


@pytest.mark.parametrize("arch", ["smollm-360m", "gemma2-2b",
                                  "qwen2-moe-a2.7b", "rwkv6-1.6b",
                                  "zamba2-1.2b", "paligemma-3b",
                                  "musicgen-large"])
def test_train_step_card_matches_cpu(cuda, arch):
    """One reduced ``train_step`` (remat=True) per family on the card
    against the CPU from the same params and ``TokenPipeline`` batch:
    lr bitwise, loss, grad norm and moments within the stated bounds, the
    step lowering its batch's loss, no custom kernel launched."""
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.train.step import TrainState, loss_and_grads, train_step
    cfg, cpu, card = _lm(arch, 3, cuda)
    tok, lab, fe = _train_inputs(cfg, 3)
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=10)
    kernels.reset_launch_counts()
    gs, gm = train_step(TrainState(card, adamw_init(card)), tok.to(cuda),
                        lab.to(cuda), cfg, frontend_inputs=None if fe is None
                        else fe.to(cuda), **kw)
    cs, cm = train_step(TrainState(cpu, adamw_init(cpu)), tok, lab, cfg,
                        frontend_inputs=fe, **kw)
    assert not any(kernels.LAUNCHES.values())
    assert gs.opt.step.is_cuda and gm["loss"].is_cuda
    assert float(gm["lr"]) == float(cm["lr"])
    assert abs(float(gm["loss"]) - float(cm["loss"])) <= 2.0 ** -9
    assert abs(float(gm["grad_norm"]) / float(cm["grad_norm"]) - 1) \
        <= 2.0 ** -6
    for got, want in ((gs.opt.mu, cs.opt.mu), (gs.opt.nu, cs.opt.nu)):
        g, w = tree_leaves(got), tree_leaves(want)
        floor = max(float(x.double().norm()) for x in w) / 256
        # MoE expert leaves may follow a choice that is not sure
        for a, b in zip(g, w):
            assert bool(torch.isfinite(a).all())
            if cfg.family != "moe":
                assert _rel_l2(a, b, floor) <= 0.1
    after, _, _ = loss_and_grads(gs.params, tok.to(cuda), lab.to(cuda), cfg,
                                 frontend_inputs=None if fe is None
                                 else fe.to(cuda))
    assert float(after) < float(gm["loss"])


def test_remat_modes_on_card(cuda, monkeypatch):
    """Reduced smollm-360m on the card with the online attention path
    (threshold and chunks patched to 8 / 8 / 16 at L = 64): the loss
    bitwise across remat False, True and "dots" (the forward does not
    depend on remat), every gradient within 1e-5 relative L2 of
    remat=False's (the backward's atomic adds may reorder f32 sums)."""
    from repro_torch.models import layers as tly
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import loss_and_grads
    monkeypatch.setattr(tly, "ATTN_CHUNK_THRESHOLD", 8)
    monkeypatch.setattr(tly, "ATTN_Q_CHUNK", 8)
    monkeypatch.setattr(tly, "ATTN_KV_CHUNK", 16)
    cfg, _, card = _lm("smollm-360m", 4, cuda)
    rng = np.random.default_rng(4)
    t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65))
                         .astype(np.int32)).to(cuda)
    out = {r: loss_and_grads(card, t[:, :-1], t[:, 1:], cfg, remat=r)
           for r in (False, True, "dots")}
    for r in (True, "dots"):
        assert torch.equal(out[r][0], out[False][0]), r
        for a, b in zip(tree_leaves(out[r][2]), tree_leaves(out[False][2])):
            assert _rel_l2(a, b, 1e-30) <= 1e-5, r


def test_train_launcher_on_card(cuda, tmp_path, caplog):
    """The training launcher with ``--device cuda``: 6 steps with a
    checkpoint every 3, then ``--resume`` to 8 ('resumed from step 6');
    the losses finite; ``--device cpu`` resumed from a copy of the same
    step-6 checkpoint gives steps 6 and 7 within 2**-8 of the card's."""
    import logging
    import shutil
    from repro_torch.launch import train as launcher
    d, c = tmp_path / "ck", tmp_path / "ck_cpu"
    base = ["--arch", "smollm-360m", "--ckpt-every", "3"]
    with caplog.at_level(logging.INFO, logger="repro_torch"):
        g = launcher.main(base + ["--steps", "6", "--ckpt-dir", str(d),
                                  "--device", "cuda"])
        shutil.copytree(d, c)
        g += launcher.main(base + ["--steps", "8", "--ckpt-dir", str(d),
                                   "--resume", "--device", "cuda"])
        cpu = launcher.main(base + ["--steps", "8", "--ckpt-dir", str(c),
                                    "--resume", "--device", "cpu"])
    assert len(g) == 8 and all(np.isfinite(g))
    assert np.abs(np.asarray(g[6:]) - np.asarray(cpu)).max() <= 2.0 ** -8
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs.count("resumed from step 6") == 2


# ----------------------------- the distributed LM ----------------------------

def _lm_mesh_rank():
    """The EP MoE (bf16 forward, int8 dispatch, f32-compute gradient, each
    data shard's local ``moe_ffn``) on a (data, model) = (2, 2) mesh, then
    the f32 pipeline on (pod, data) = (4, 1): first on the card, then on
    the CPU (gloo meshes of the same four processes)."""
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.models import layers as tly
    from repro_torch.models import moe
    from repro_torch.models.config import MoEConfig
    cfg = MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared=1,
                    capacity_factor=1.25)
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(32, cfg, g, "cpu", ep_degree=2)
    x = torch.randn((4, 16, 32), generator=g)
    w = torch.randn((4, 16, 32), generator=g)
    Ws = torch.randn((4, 16, 16), generator=g) * 0.5
    xp = torch.randn((8, 16), generator=g)
    out = {}
    for where in ("cuda", "cpu"):
        mesh = Mesh((2, 2), "gloo", where, ("data", "model"))
        pw = {k: v.to(where) for k, v in p.items()}
        xw = x.to(where)
        y, aux, dropped = moe.moe_ffn_shard_map(pw, xw, cfg, mesh, ("data",))
        yq = moe.moe_ffn_shard_map(pw, xw, cfg, mesh, ("data",),
                                   quantize_dispatch=True)[0]
        shards = [moe.moe_ffn(pw, xw[2 * d:2 * d + 2], cfg)
                  for d in range(2)]
        tly.COMPUTE_DTYPE = moe.COMPUTE_DTYPE = torch.float32
        pg = {k: v.clone().requires_grad_() for k, v in pw.items()}
        xg = xw.clone().requires_grad_()
        yg, auxg, _ = moe.moe_ffn_shard_map(pg, xg, cfg, mesh, ("data",))
        grads = torch.autograd.grad(
            (yg.float() * w.to(where)).sum() + auxg, [xg, *pg.values()])
        tly.COMPUTE_DTYPE = moe.COMPUTE_DTYPE = torch.bfloat16
        pmesh = Mesh((4, 1), "gloo", where, ("pod", "data"))
        fn = pipeline_apply(lambda W, xb: torch.tanh(xb @ W), pmesh,
                            stage_axis="pod", n_micro=4, data_axes=("data",))
        Wg = Ws.to(where).requires_grad_()
        yp = fn(Wg, xp.to(where))
        gp, = torch.autograd.grad((yp ** 2).sum(), Wg)
        seq = []
        for mb in xp.to(where).reshape(4, 2, 16):
            for s in range(4):
                mb = torch.tanh(mb @ Ws[s].to(where))
            seq.append(mb)
        out[where] = dict(
            y=y.float().cpu(), aux=float(aux), dropped=float(dropped),
            yq=yq.float().cpu(),
            local_y=torch.cat([s[0] for s in shards]).float().cpu(),
            local_aux=float((shards[0][1] + shards[1][1]) / 2),
            local_dropped=float((shards[0][2] + shards[1][2]) / 2),
            grads=[t.cpu() for t in grads], yp=yp.detach().cpu(),
            gp=gp.cpu(), seq_equal=torch.equal(yp.detach(), torch.cat(seq)))
    return out


def _bf16_ulps(want, ulps=8):
    top = float(want.abs().max())
    return ulps * 2.0 ** (np.floor(np.log2(top)) - 7) if top else 0.0


def test_lm_mesh_ep_and_pipeline_card_matches_cpu(cuda):
    """Four gloo ranks on the card against the same four processes' gloo
    CPU meshes: ``moe_ffn_shard_map`` (y within 8 bf16 ulps on the rows
    whose routing is sure, aux within 1e-3 relative, dropped equal when
    every row is sure), its int8 dispatch within 0.05 of the bf16 one,
    the shard oracle on the card (EP equals the local ``moe_ffn`` on each
    data shard within 8 ulps, aux to f32 rounding, dropped equal), the f32
    gradient of sum(y w) + aux within 1e-4 relative L2; the f32 pipeline
    within 1e-6 (forward) and 1e-5 (gradient) of the CPU's and bitwise its
    own sequential composition; every rank's bits equal."""
    from repro_torch.distributed.mesh import Mesh, spawn
    from repro_torch.models import moe
    from repro_torch.models.config import MoEConfig
    ranks = spawn(_lm_mesh_rank, Mesh((2, 2), "gloo", "cuda",
                                      ("data", "model")), timeout=600)
    for r in ranks[1:]:
        for where in ("cuda", "cpu"):
            for k in ("y", "yq", "yp", "gp"):
                assert torch.equal(r[where][k], ranks[0][where][k]), k
            assert all(torch.equal(a, b) for a, b in
                       zip(r[where]["grads"], ranks[0][where]["grads"]))
    card, cpu = ranks[0]["cuda"], ranks[0]["cpu"]
    # the routing margin on the CPU's router probabilities
    cfg = MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared=1,
                    capacity_factor=1.25)
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe(32, cfg, g, "cpu", ep_degree=2)
    x = torch.randn((4, 16, 32), generator=g)
    logits = (x.reshape(-1, 32).bfloat16() @ p["router"].bfloat16()).float()
    probs = torch.softmax(logits, -1)
    srt = probs.sort(-1, descending=True).values
    tol = 2.0 ** -7 * float(probs.max())
    sure = ((srt[:, 1] - srt[:, 2] > tol) & (srt[:, 0] - srt[:, 1] > tol))
    y, want = card["y"].reshape(-1, 32), cpu["y"].reshape(-1, 32)
    assert float((y[sure] - want[sure]).abs().max()) <= _bf16_ulps(want)
    low = int((~sure).sum())
    assert abs(card["aux"] - cpu["aux"]) <= 1e-3 * cpu["aux"] + 8 / 64 * low
    if low == 0:
        assert card["dropped"] == cpu["dropped"]
    rel = float((card["yq"] - card["y"]).abs().max() / card["y"].abs().max())
    assert rel < 0.05
    assert float((card["y"] - card["local_y"]).abs().max()) <= \
        _bf16_ulps(card["local_y"])
    assert abs(card["aux"] - card["local_aux"]) <= \
        4 * np.spacing(np.float32(card["local_aux"]))
    assert card["dropped"] == card["local_dropped"]
    for a, b in zip(card["grads"], cpu["grads"]):
        assert float((a.double() - b.double()).norm()) <= \
            1e-4 * float(b.double().norm())
    assert float((card["yp"] - cpu["yp"]).abs().max()) <= 1e-6
    assert float((card["gp"] - cpu["gp"]).norm()) <= \
        1e-5 * float(cpu["gp"].norm())
    assert card["seq_equal"] and cpu["seq_equal"]


@pytest.mark.parametrize("path", ["fused", "fused_topk"])
def test_tiles_and_knobs_on_card(cuda, path):
    """``tiles=`` through the kernel plan's clustering (K5 / K6 or K8 / K9)
    and the wrappers' TPU knobs on card tensors: launches as without them,
    outputs bitwise the same."""
    tb, params = _fig1_case(cuda)
    base = run_dsc(tb, params, plan=_path_plan(path), device=cuda)
    for tiles in ((8, 128), (16, 256), (8, 8)):
        before = dict(kernels.LAUNCHES)
        out = run_dsc(tb, params, plan=_path_plan(path).replace(
            cluster_bu=tiles[0], cluster_bs=tiles[1]), device=cuda)
        ran = {k for k, v in kernels.LAUNCHES.items() if v > before[k]}
        assert ran == PATH_KERNELS[path]
        for f in ("member_of", "member_sim", "is_rep", "is_outlier"):
            assert torch.equal(getattr(out.result, f),
                               getattr(base.result, f)), (tiles, f)
    sim, rank, unres, rep, valid = _k5_instance(cuda, 300, "mixed", 300)
    sims, ids = torch.topk(sim, 9, dim=1)
    ids = ids.to(torch.int32).contiguous()
    for fn, args, kw in (
            (cluster_round_scan, (sim, rank, unres, rep, 0.5),
             dict(bu=16, bs=256, interpret=False)),
            (cluster_assign, (sim, rank, rep, valid, 0.5),
             dict(bu=1, bs=1, interpret=True)),
            (topk_cluster_round_scan, (ids, sims.contiguous(), rank, unres,
                                       rep, 0.5), dict(bs=3)),
            (topk_cluster_assign, (ids, sims.contiguous(), rank, rep, valid,
                                   0.5), dict(bs=128, interpret=False))):
        want = fn(*args)
        got = fn(*args, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
