#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout; it needs no build step (the kernels
build from ``src/repro_torch/kernels/csrc`` at first use) and one card.

1. Build the CUDA kernels with nvcc for sm_90a; print the card and the
   build time.
2. End-to-end parity at T = 512, materialize mode: the kernel plan twice
   (bitwise equal outputs: no non-deterministic scatter) and the plain
   plan (equal labels).
3. The same at T = 512 in fused mode: the fused kernel plan twice
   (bitwise), the fused plan with plain segmentation and clustering
   (equal labels), the materialize kernel plan (equal labels, the max
   difference of ``sim`` printed); once more with ``delta_t > 0``.
4. The two main paths: ``run_dsc`` on the repo's per-device
   configuration ``dsc_brest`` (4096 AIS-like vessels x 128 points, 8
   lanes, w = 20, TSA2) with the kernel plan, first in materialize mode,
   then in fused mode.  Launch counts are zeroed just before each run and
   read just after; each run must launch exactly its path's kernels.
   Prints stage times (CUDA events), clustering rounds, peak device memory
   and the cluster / member / outlier counts; the fused labels must equal
   the materialize labels.
5. Each kernel against its plain PyTorch version on the card, on its main
   path's full-size inputs: integer / boolean outputs equal, float outputs
   bitwise equal.  Times the kernel, the plain version and, where one
   PyTorch call computes the same function, that call.
6. The fused path at ``dsc_sis`` (8192 vessels x 128 points, S = 65,536;
   the same generator and parameters): launch counts, sanity checks,
   stage times and peak memory.

Top-K similarity (``sim_mode="topk"``, the default K = 32 and widening):

* T = 512, both modes with the kernel plan: labels equal to the dense
  runs, the ``TopKSim`` bitwise ``topk_from_dense`` of the dense matrix
  at the final K (after step 3);
* the fused top-K path at ``dsc_brest`` (after step 4): launch counts
  (K7 = dispatches x S/Sb, K8 = rounds summed over the dispatches, K9 =
  dispatches), labels equal to the dense fused run, the same bitwise list
  check, stage times, final K, dispatches and a peak below one ``[S, S]``
  float32 matrix;
* K7 (one panel, bitwise against its plain version and against K4's
  ``raw``), K8 and K9 against their plain versions (in step 5);
* the fused top-K path at ``dsc_sis``: labels equal to the dense dsc_sis
  run's (after step 6).

Index pruning (``use_index=True``, the pruned kernels K10-K13):

* T = 512: the materialize, fused and fused top-K kernel plans with the
  index give the labels of the same plans without it (after the top-K
  parity step);
* dsc_brest as the launcher lays it out (after the brest main paths): the
  three pruned paths, each launching exactly its kernels; labels, ``sim``
  and the top-K lists equal to the unpruned runs'; then K10 bitwise K1,
  K11 bitwise K2 (vote and words), K12 bitwise K4, K13 bitwise K7 on
  every panel; tile counts, tile-list widths, planning ms, stage times and
  peak memory printed;
* the same 4096 vessels with rows stably sorted by lane (the layout of
  ``benchmarks/kernel_bench.py``), where the plans skip tiles: the three
  unpruned and the three pruned paths, the same checks, and each pruned
  kernel against its plain version (timed, with its bound).

The entry points off the DSC paths (after the dsc_sis runs):

* LCSS (``lcss_similarity``, K14) on the lane-sorted dsc_brest vessels,
  each paired with the next 8 rows (B = 32,768 pairs of 128 x 128 points,
  dsc_brest's eps): one launch on the entry point's run; the kernel
  bitwise its sheared plain twin on every pair, the row scan on the first
  pairs, and itself on the swapped pairs; 0 <= weighted <= count <=
  min(n, m);
* attention (``flash_attention``, K15) at the shapes of two models the
  repo supports: smollm-360m prefill (15 heads, 5 KV, hd 64, L = 4096,
  causal) in float32 and bfloat16, a gemma2-2b local layer (8 heads, 4
  KV, hd 256, softcap 50, window 4096, L = 8192) in bfloat16, and one
  gemma2-2b decode step (Lq = 1 against M = 8192, ``max_kv``), and the
  gemma2-2b local layer in float32 with q unscaled, so that the scores
  reach into the softcap, and one small hd-512 case for the general path:
  one launch per case on the entry point's run; each against the plain
  version within its stated tolerance, timed, and the smollm cases beside
  ``scaled_dot_product_attention(is_causal=True)``; the K15 path each case
  took (``bf16_mma``, ``f32_tiled`` or ``general``, and its key split),
  and the tiles it skipped out of those it swept, equal to the plain
  mirror of its tile test.

Prints one JSON ``kernels`` line, then the card's name and power limit,
then ``{"ok": true, "device": {...}}`` as the last line.  Any mismatch or
error exits non-zero without the result line; so does a machine without a
card or a directory without the port.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; f32 outside
# the tensor cores is 67 TFLOP/s counting an FMA as two operations, so
# 33.5e12 f32 instructions per second for code built with -fmad=false;
# bf16 in the tensor cores 989 TFLOP/s (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
F32_OPS_PER_S = F32_FLOPS_PER_S / 2
BF16_FLOPS_PER_S = 989e12
# f32 operations of one K1 pair evaluation: dx, dy, dx*dx, dy*dy, the sum,
# dt and the two threshold compares (no FMA)
K1_OPS_PER_PAIR = 8
REPLACES = {
    "stjoin_best_match": "src/repro/kernels/stjoin/stjoin.py:893",
    "stjoin_vote_fused": "src/repro/kernels/stjoin/stjoin.py:583",
    "jaccard_window": "src/repro/kernels/jaccard/jaccard.py:72",
    "stjoin_sim_fused": "src/repro/kernels/stjoin/stjoin.py:711",
    "stjoin_sim_panel_fused": "src/repro/kernels/stjoin/stjoin.py:444",
    "round_scan": "src/repro/kernels/cluster/cluster.py:99",
    "claim_max": "src/repro/kernels/cluster/cluster.py:120",
    "topk_round_scan": "src/repro/kernels/cluster/cluster.py:195",
    "topk_claim_max": "src/repro/kernels/cluster/cluster.py:216",
    "stjoin_best_match_pruned": "src/repro/kernels/stjoin/stjoin.py:811",
    "stjoin_vote_fused_pruned": "src/repro/kernels/stjoin/stjoin.py:637",
    "stjoin_sim_fused_pruned": "src/repro/kernels/stjoin/stjoin.py:763",
    "stjoin_sim_panel_fused_pruned":
        "src/repro/kernels/stjoin/stjoin.py:515",
    "lcss_wavefront": "src/repro/kernels/lcss/lcss.py:57",
    "flash_attention_fwd": "src/repro/kernels/attention/flash.py:83",
}
CSRC = "src/repro_torch/kernels/csrc/"
# the source of each kernel outside dsc_kernels.cu
SOURCES = {"lcss_wavefront": "lcss_kernels.cu",
           "flash_attention_fwd": "attention_kernels.cu"}
# the kernels each main path launches, and no other
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
PRUNED_PATHS = ("materialize", "fused", "fused_topk")
LABELS = ("member_of", "is_rep", "is_outlier")


class Failed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events (no host
    overhead between the kernels, unlike ``time_ms`` on back-to-back
    calls, which a small kernel can outrun)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(nbytes: float, ops: float = 0.0, rate: float = F32_OPS_PER_S):
    """The larger of the bytes over HBM's rate and the operations over
    ``rate`` (f32 instructions by default)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / rate * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def window_partners(batch, eps_t: float):
    """Per valid point ``[T, M]`` (0 elsewhere): the valid points of the
    other trajectories with |dt| <= eps_t, the pairs whose distance the
    join needs.  A kernel that uses the time order of each trajectory's
    points evaluates only these; K1 as built evaluates all P * C * Mc."""
    t = batch.t.double()
    tv = torch.where(batch.valid, t, torch.inf)
    lo, hi = t - eps_t, t + eps_t
    flat = tv.flatten().sort().values
    every = (torch.searchsorted(flat, hi, right=True)
             - torch.searchsorted(flat, lo))
    rows = tv.sort(dim=1).values
    own = (torch.searchsorted(rows, hi, right=True)
           - torch.searchsorted(rows, lo))
    return torch.where(batch.valid, every - own, 0)


def k1_window_pairs(batch, eps_t: float) -> int:
    """(ref point, candidate point) pairs of the self-join that the join
    needs (``window_partners`` summed)."""
    return int(window_partners(batch, eps_t).sum())


def brest_batch(n_vessels: int, dev, delta_t: float = 0.0,
                sort_by_lane: bool = False):
    """The launcher's ``dsc_brest`` data and parameters
    (``repro.launch.run_dsc``: eps_sp = 0.15 * diameter, eps_t = mean
    sampling interval, delta_t = 0, w = 20, tau = 0.4, -1 sigma
    thresholds, 8 subtrajectories per trajectory) with TSA2.  The
    launcher's own default for dsc_brest is TSA1 (the registry's
    ``segmentation="tsa1"``); TSA2 is chosen here so that the Jaccard
    kernel runs: the launcher equivalent is ``--config dsc_brest
    --n-trajs 4096 --segmentation tsa2``.  ``dsc_sis`` has the same
    generator and parameters at 8192 vessels.

    ``sort_by_lane``: the same vessels and parameters with the rows stably
    sorted by lane, ids following their rows (the layout of
    ``benchmarks/kernel_bench.py``): tiles of 32 neighbouring rows then
    stay on few lanes, and the index plans skip tiles."""
    from repro_torch.core.types import DSCParams, TrajectoryBatch
    from repro_torch.data.synthetic import ais_like, default_dsc_params_for
    batch, lanes = ais_like(n_vessels=n_vessels, max_points=128, n_lanes=8,
                            seed=0, device=dev)
    diam, mean_dt = default_dsc_params_for(batch)
    params = DSCParams(eps_sp=0.15 * diam, eps_t=mean_dt, delta_t=delta_t,
                       w=20, tau=0.4, alpha_sigma=-1.0, k_sigma=-1.0,
                       max_subtrajs_per_traj=8, segmentation="tsa2")
    if sort_by_lane:
        o = torch.from_numpy(lanes.argsort(kind="stable")).to(dev)
        batch = TrajectoryBatch(x=batch.x[o], y=batch.y[o], t=batch.t[o],
                                valid=batch.valid[o],
                                traj_id=batch.traj_id[o])
    return batch, params


def kernel_plan(path: str = "materialize"):
    """The kernel plan of a path: ``"materialize"``, ``"fused"``,
    ``"materialize_topk"`` or ``"fused_topk"`` (the default K and panel),
    with the index where the path ends in ``"+index"``."""
    from repro_torch.core.plan import EnginePlan
    path, _, index = path.partition("+")
    mode, _, sim = path.partition("_")
    return EnginePlan(mode=mode, use_kernel=True, seg_use_kernel=True,
                      cluster_use_kernel=True, sim_mode=sim or "dense",
                      cluster_engine="rounds", use_index=index == "index")


def check_output(out, batch, params):
    """The repo's own sanity conditions on a pipeline output."""
    T, M = batch.x.shape
    S = T * params.max_subtrajs_per_traj
    r = out.result
    check(out.vote.shape == (T, M) and torch.isfinite(out.vote).all(),
          "vote: shape or non-finite values")
    if out.sim is None:
        tk = out.sim_topk
        check(tk.ids.shape == tk.sims.shape == (S, tk.k)
              and torch.isfinite(tk.sims).all(),
              "top-K lists: shape or non-finite values")
        check(bool(((tk.ids >= -1) & (tk.ids < S)).all())
              and bool((tk.sims >= 0).all())
              and bool((tk.sims[:, :-1] >= tk.sims[:, 1:]).all())
              and bool(((tk.ids >= 0) == (tk.sims > 0)).all()),
              "top-K lists: ids out of range or sims not descending")
        check(int(out.sim_overflow) == 0, "top-K certificate fails")
    else:
        check(out.sim.shape == (S, S) and torch.isfinite(out.sim).all(),
              "sim: shape or non-finite values")
        # Eq. 2 divides by min(|r'|, |s'|), so entries may exceed 1
        check(bool((out.sim >= 0).all()), "negative similarity")
    check(torch.isfinite(r.alpha_used) and torch.isfinite(r.k_used),
          "alpha / k not finite")
    members = ~r.is_rep & (r.member_of >= 0)
    owners = r.member_of[members].long()
    check(bool(r.is_rep[owners].all()), "a member's owner is no rep")
    check(bool((r.member_of[r.is_rep] == torch.nonzero(r.is_rep)[:, 0]
                .to(torch.int32)).all()), "a rep does not own itself")
    check(not bool((r.is_outlier & (r.is_rep | members)).any()),
          "an outlier is also clustered")
    check(int(r.is_rep.sum()) > 0, "no cluster found")
    check(0.0 < float(out.sscr) and float(out.rmse) <= params.eps_sp,
          "sscr / rmse out of range")


def same_labels(a, b, what: str):
    for f in LABELS:
        check(torch.equal(getattr(a.result, f), getattr(b.result, f)),
              f"{what}: {f} differs")


def same_topk(out, dense, what: str):
    """``out``'s lists bitwise ``topk_from_dense`` of ``dense``'s matrix at
    the final K, field by field."""
    from repro_torch.core.similarity import topk_from_dense
    want = topk_from_dense(dense.sim, dense.table, out.sim_topk.k)
    for f in ("ids", "sims", "spill", "degree", "row_sum", "row_sumsq"):
        check(torch.equal(getattr(out.sim_topk, f), getattr(want, f)),
              f"{what}: TopKSim.{f} not bitwise topk_from_dense")


def same_output(a, b) -> list[str]:
    diffs = []
    pairs = {"vote": (a.vote, b.vote), "score": (a.seg.score, b.seg.score),
             "sub_local": (a.seg.sub_local, b.seg.sub_local),
             "sim": (a.sim, b.sim), "sscr": (a.sscr, b.sscr)}
    for f in ("member_of", "member_sim", "is_rep", "is_outlier",
              "alpha_used", "k_used"):
        pairs[f] = (getattr(a.result, f), getattr(b.result, f))
    for name, (x, y) in pairs.items():
        if not torch.equal(x, y):
            diffs.append(name)
    return diffs


def phase_parity(dev):
    """T = 512: kernel plan twice (bitwise), plain plan (equal labels)."""
    from repro_torch.core.dsc import run_dsc
    batch, params = brest_batch(512, dev)
    k1 = run_dsc(batch, params, plan=kernel_plan(), device=dev)
    k2 = run_dsc(batch, params, plan=kernel_plan(), device=dev)
    diffs = same_output(k1, k2)
    check(not diffs, f"kernel plan not deterministic: {diffs}")
    plain = run_dsc(batch, params, device=dev)
    for f in ("member_of", "is_rep", "is_outlier"):
        check(torch.equal(getattr(k1.result, f), getattr(plain.result, f)),
              f"T=512 kernel vs plain plan: {f} differs")
    check_output(k1, batch, params)
    log(f"phase parity (T=512): kernel plan deterministic; labels equal to "
        f"the plain plan; {int(k1.result.is_rep.sum())} clusters, "
        f"{int(k1.result.is_outlier.sum())} outliers, rounds {k1.rounds}")


def phase_parity_fused(dev):
    """T = 512, fused mode, with delta_t = 0 and > 0: the fused kernel plan
    twice (bitwise), the fused plan with plain segmentation and clustering
    (equal labels; K2 and K4 run on the card in any fused plan), and the
    materialize kernel plan (equal labels, the sim difference printed)."""
    from repro_torch.core.dsc import run_dsc
    from repro_torch.core.plan import EnginePlan
    batch, params = brest_batch(512, dev)
    for k in (0.0, 3.0):
        p = params.replace(delta_t=k * params.eps_t)
        f1 = run_dsc(batch, p, plan=kernel_plan("fused"), device=dev)
        f2 = run_dsc(batch, p, plan=kernel_plan("fused"), device=dev)
        diffs = same_output(f1, f2)
        check(not diffs, f"fused kernel plan not deterministic: {diffs}")
        others = {"fused plain": run_dsc(batch, p, device=dev,
                                         plan=EnginePlan(mode="fused")),
                  "materialize kernel": run_dsc(batch, p, device=dev,
                                                plan=kernel_plan())}
        for name, o in others.items():
            for f in ("member_of", "is_rep", "is_outlier"):
                check(torch.equal(getattr(f1.result, f),
                                  getattr(o.result, f)),
                      f"T=512 delta_t={p.delta_t:.6g}: fused kernel vs "
                      f"{name} plan: {f} differs")
        check_output(f1, batch, p)
        sim_diff = float((f1.sim - others["materialize kernel"].sim)
                         .abs().max())
        log(f"phase parity fused (T=512, delta_t={p.delta_t:.6g}): "
            f"deterministic; labels equal to the fused plain and the "
            f"materialize kernel plans; max |sim fused - sim materialize| "
            f"= {sim_diff}; {int(f1.result.is_rep.sum())} clusters, "
            f"{int(f1.result.is_outlier.sum())} outliers, "
            f"rounds {f1.rounds}")


def phase_parity_topk(dev):
    """T = 512, top-K with the kernel plan in both modes: labels equal to
    the dense kernel runs and the lists bitwise ``topk_from_dense`` of
    the dense matrix at the final K."""
    from repro_torch.core.dsc import run_dsc
    batch, params = brest_batch(512, dev)
    for mode in ("materialize", "fused"):
        dense = run_dsc(batch, params, plan=kernel_plan(mode), device=dev)
        out = run_dsc(batch, params, plan=kernel_plan(mode + "_topk"),
                      device=dev)
        check(out.sim is None, f"T=512 {mode} top-K: a dense matrix")
        same_labels(out, dense, f"T=512 {mode} top-K vs dense")
        same_topk(out, dense, f"T=512 {mode} top-K")
        check(torch.equal(out.sscr, dense.sscr), f"T=512 {mode}: sscr")
        check_output(out, batch, params)
        log(f"phase parity top-K (T=512, {mode}): labels equal to the dense "
            f"run, lists bitwise topk_from_dense; final K={out.sim_topk.k} "
            f"after {out.dispatches} dispatches, rounds {out.rounds}")


def phase_parity_index(dev):
    """T = 512: each kernel plan with the index gives the labels of the
    same plan without it."""
    from repro_torch.core.dsc import run_dsc
    batch, params = brest_batch(512, dev)
    for path in PRUNED_PATHS:
        dense = run_dsc(batch, params, plan=kernel_plan(path), device=dev)
        out = run_dsc(batch, params, plan=kernel_plan(path + "+index"),
                      device=dev)
        same_labels(out, dense, f"T=512 {path}: index vs no index")
        check_output(out, batch, params)
    log("phase parity index (T=512): labels with the index equal those "
        f"without it on {', '.join(PRUNED_PATHS)}")


def same_pruned(outs, pouts, what: str):
    """The pruned paths' outputs against the unpruned ones: labels, the
    dense ``sim`` and the top-K lists bitwise."""
    for path in PRUNED_PATHS:
        a, b = outs[path], pouts[path]
        same_labels(b, a, f"{what} {path}: index vs no index")
        check(torch.equal(b.seg.sub_local, a.seg.sub_local),
              f"{what} {path}: sub_local differs")
        if a.sim is not None:
            check(torch.equal(b.sim, a.sim), f"{what} {path}: sim differs")
        else:
            check(torch.equal(b.sim_topk.ids, a.sim_topk.ids)
                  and torch.equal(b.sim_topk.sims, a.sim_topk.sims),
                  f"{what} {path}: top-K lists differ")
    log(f"{what}: with the index, labels, sub_local, sim and the top-K "
        "lists equal the unpruned runs'")


def plan_index(batch, params, report, name: str):
    """Both tile plans of the batch's self-join, timed (host clock around
    synchronized calls, the transposition of the fused plan included):
    ``(join tile_ids, fused FusedTilePlan)``."""
    from repro_torch.kernels.stjoin import ops as sj
    eps = (params.eps_sp, params.eps_t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mask, counts, _ = sj.plan_join_index(batch, batch, *eps)
    join_ids = sj._compact(mask, counts, None, "pruned join")
    torch.cuda.synchronize()
    join_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fplan = sj.plan_fused_tiles(*(batch.x, batch.y, batch.t,
                                  batch.valid) * 2, *eps)
    _ = fplan.by_row, fplan.by_tile
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3
    jk, jd = int(counts.sum()), mask.numel()
    fk = int((fplan.tile_ids >= 0).sum())
    fd = fplan.tile_ids.shape[0] * -(-batch.num_trajs // sj.FUSED_BC)
    log(f"index plans ({name}): join {jk} of {jd} tiles kept "
        f"({100 * jk / jd:.2f}%), tile_ids {list(join_ids.shape)}, planned "
        f"in {join_ms:.2f} ms; fused {fk} of {fd} tiles kept "
        f"({100 * fk / fd:.2f}%), tile_ids {list(fplan.tile_ids.shape)}, "
        f"planned and transposed in {fused_ms:.2f} ms")
    report[f"{name}_index_plans"] = dict(
        join_kept=jk, join_dense=jd, join_width=join_ids.shape[1],
        join_plan_ms=join_ms, fused_kept=fk, fused_dense=fd,
        fused_width=fplan.tile_ids.shape[1], fused_plan_ms=fused_ms)
    return join_ids, fplan


def kept_window_pairs(batch, eps_t: float, tile_ids, bp: int, bc: int,
                      rows=None, cands=None) -> int:
    """``window_partners`` restricted to the (block of ``bp`` points,
    tile of ``bc`` candidates) pairs a plan keeps: the (point, candidate
    point) pairs with |dt| <= eps_t of another trajectory that a pruned
    kernel has to evaluate.  ``rows`` / ``cands``: only the points of
    these reference rows / of these candidates (closed ranges)."""
    from repro_torch.kernels.stjoin.ref import tile_keep
    T, M = batch.x.shape
    t = batch.t.double()
    tv = torch.where(batch.valid, t, torch.inf)
    lo, hi = (t - eps_t).reshape(-1), (t + eps_t).reshape(-1)
    rows_sorted = tv.sort(dim=1).values
    own = (torch.searchsorted(rows_sorted, (t + eps_t), right=True)
           - torch.searchsorted(rows_sorted, (t - eps_t))).reshape(-1)
    keep = tile_keep(tile_ids, -(-T // bc))
    pts = torch.arange(T * M, device=t.device)
    ok = batch.valid.reshape(-1)
    if rows is not None:
        ok = ok & (pts // M >= rows[0]) & (pts // M <= rows[1])
    c_lo, c_hi = (0, T - 1) if cands is None else cands
    total = 0
    for j in range(c_lo // bc, c_hi // bc + 1):
        a, b = max(j * bc, c_lo), min((j + 1) * bc, c_hi + 1)
        seq = tv[a:b].reshape(-1).sort().values
        p = torch.nonzero(ok & keep[pts // bp, j])[:, 0]
        cnt = (torch.searchsorted(seq, hi[p], right=True)
               - torch.searchsorted(seq, lo[p]))
        mine = (p // M >= a) & (p // M < b)
        total += int((cnt - torch.where(mine, own[p], 0)).sum())
    return total


def live_reads(pairs, bp: int, bc: int, P: int, C: int, cands=None):
    """The reference points ``[P]`` and candidates ``[C]`` (bool) that a
    pruned kernel reads for the live (block, tile) entries ``pairs
    [n, 2]``: the points of each block, the candidates of each tile
    (``cands``: only those in this closed range)."""
    dev = pairs.device
    pts = torch.zeros(P, dtype=torch.bool, device=dev)
    cand = torch.zeros(C, dtype=torch.bool, device=dev)
    blk, tile = pairs[:, 0].long().unique(), pairs[:, 1].long().unique()
    p = (blk[:, None] * bp + torch.arange(bp, device=dev)).reshape(-1)
    pts[p[p < P]] = True
    c = (tile[:, None] * bc + torch.arange(bc, device=dev)).reshape(-1)
    lo, hi = (0, C - 1) if cands is None else cands
    cand[c[(c >= lo) & (c <= hi)]] = True
    return pts, cand


def read_bytes(pts, cand, Mc: int, gids: bool = False) -> int:
    """``join_input_bytes`` of the points and candidates read (``gids``:
    with their slot maps, 4 bytes a point)."""
    n_p, n_c = int(pts.sum()), int(cand.sum())
    return (join_input_bytes(n_p, n_c, Mc)
            + (4 * (n_p + n_c * Mc) if gids else 0))


def phase_pruned_kernels(batch, params, sub, join_ids, fplan, launches,
                         rows, name: str, n_plain: int):
    """K10-K13 on the batch's plans, each against its dense kernel bit for
    bit (K13 on every panel) and against its plain version bit for bit,
    on the first ``n_plain`` reference rows (K13 on one whole panel).
    With ``n_plain`` = T, each is also timed, with its bound, into
    ``rows``.  ``sub``: the main path's segmentation (``sub_local``).  The
    plain versions of K11 and K12 share one pruned plain join (the fused
    plan's), as K2's and K4's share K1's: their plain time is that join's
    plus their tail.  A bound counts the operands a kernel reads for its
    plan's live entries (``live_reads``), those entries, its outputs, and
    the pairs its kept tiles need (``kept_window_pairs``)."""
    from repro_torch.core.similarity import plan_panel, scatter_raw, slot_ids
    from repro_torch.kernels.stjoin import ops as sj
    from repro_torch.kernels.stjoin.ref import (run_refine,
                                                stjoin_pruned_ref,
                                                stjoin_sim_panel_fused_ref,
                                                vote_words_ref)
    T, M = batch.x.shape
    C, Mc = T, M
    P = T * M
    ms_ = params.max_subtrajs_per_traj
    S = T * ms_
    eps = (params.eps_sp, params.eps_t, params.delta_t)
    arrs = (batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2
    ref_ops, cand_ops = sj._flat_operands(*arrs)
    gid = slot_ids(sub, ms_, S)
    tiles = (fplan.tile_ids, M, fplan.bc)
    timed = n_plain == T
    nP, nS = n_plain * M, n_plain * ms_
    head = tuple(a[:nP] for a in ref_ops)   # the first rows' points
    rng = f"rows [0, {n_plain})"

    # ---- K10 against K1 and its plain version -----------------------------
    kw, ki = sj.stjoin_best_match_pruned(*ref_ops, *cand_ops, join_ids,
                                         *eps[:2])
    dw, di = sj.stjoin_best_match(*ref_ops, *cand_ops, *eps[:2])
    check(torch.equal(kw, dw) and torch.equal(ki, di),
          f"{name}: K10 not bitwise K1")
    del dw, di
    plain_out = []
    plain = time_ms(lambda: plain_out.append(stjoin_pruned_ref(
        *head, *cand_ops, join_ids, *eps[:2], bp=sj.JOIN_BP,
        bc=sj.JOIN_BC)), reps=1, warmup=0)
    pw, pi = plain_out.pop()
    err = float((kw[:nP] - pw).abs().max())
    check(torch.equal(kw[:nP], pw) and torch.equal(ki[:nP], pi),
          f"{name}: K10 not bitwise its plain version on {rng} (max err "
          f"{err})")
    del pw, pi
    ms = time_ms(lambda: sj.stjoin_best_match_pruned(
        *ref_ops, *cand_ops, join_ids, *eps[:2], out_w=kw, out_idx=ki),
        reps=3)
    ms1 = time_ms(lambda: sj.stjoin_best_match(
        *ref_ops, *cand_ops, *eps[:2], out_w=kw, out_idx=ki), reps=3)
    log(f"{name}: K10 {ms:.3f} ms (its two fills included), K1 {ms1:.3f} "
        "ms, on the same inputs")
    if timed:
        live, _ = sj._live_pairs(join_ids)
        pairs = kept_window_pairs(batch, params.eps_t, join_ids, sj.JOIN_BP,
                                  sj.JOIN_BC)
        nbytes = (read_bytes(*live_reads(live, sj.JOIN_BP, sj.JOIN_BC, P,
                                         C), Mc)
                  + 8 * live.shape[0] + 8 * P * C)
        kernel_row(rows, "stjoin_best_match_pruned", launches, err, ms,
                   plain, bound_ms(nbytes, K1_OPS_PER_PAIR * pairs))
        log(f"  K10: {live.shape[0]} live entries, {pairs} needed pairs in "
            "kept tiles; library none")
    del kw, ki
    # the materialize join stage's join, whole (plan, fills, K10 / K1), in
    # turns: dense, index, index, dense
    join = {False: sj.best_match_join_kernel, True: sj.best_match_join_pruned}
    jms = {False: 0.0, True: 0.0}
    for idx in (False, True, True, False):
        jms[idx] += time_ms(lambda: join[idx](batch, batch, *eps[:2]),
                            reps=2) / 2
    log(f"{name}: the join, whole wrapper: with the index {jms[True]:.3f} "
        f"ms (plan, two fills, K10), dense {jms[False]:.3f} ms (K1)")

    # ---- K11 against K2, K12 against K4 -----------------------------------
    kv, kwords = sj.stjoin_vote_fused_arrays(*arrs, *eps, tile_ids=fplan)
    dv, dwords = sj.stjoin_vote_fused_arrays(*arrs, *eps)
    check(torch.equal(kv, dv) and torch.equal(kwords, dwords),
          f"{name}: K11 vote / words not bitwise K2's")
    del dv, dwords
    raw = sj.stjoin_sim_fused(batch, batch, sub, sub, ms_, *eps,
                              tile_ids=fplan)
    draw = sj.stjoin_sim_fused(batch, batch, sub, sub, ms_, *eps)
    check(torch.equal(raw, draw), f"{name}: K12 raw not bitwise K4's")
    del draw
    if timed:
        ms11 = time_ms(lambda: sj.stjoin_vote_fused_arrays(
            *arrs, *eps, tile_ids=fplan), reps=3)
        ms12 = time_ms(lambda: sj.stjoin_sim_fused(
            batch, batch, sub, sub, ms_, *eps, tile_ids=fplan), reps=3)

    # ---- K11 and K12 against their plain versions -------------------------
    plain_out = []
    join_ms = time_ms(lambda: plain_out.append(stjoin_pruned_ref(
        *head, *cand_ops, fplan.tile_ids, *eps[:2], bp=M, bc=fplan.bc)),
        reps=1, warmup=0)
    pw, pi = plain_out.pop()
    ref_t = batch.t.reshape(-1)[:nP]
    tail = time_ms(lambda: plain_out.append(vote_words_ref(
        run_refine(pw, None, ref_t, M, params.delta_t)[0])), reps=1,
        warmup=0)
    pv, pwords = plain_out.pop()
    err = float((kv.view(-1)[:nP] - pv).abs().max())
    check(torch.equal(kv.view(-1)[:nP], pv)
          and torch.equal(kwords.view(P, -1)[:nP], pwords),
          f"{name}: K11 not bitwise its plain version on {rng} (max err "
          f"{err})")
    W = pwords.shape[1]
    del pv, pwords
    live, _ = fplan.by_row
    if timed:
        fpairs = kept_window_pairs(batch, params.eps_t, fplan.tile_ids, M,
                                   fplan.bc)
        reads = live_reads(live, M, fplan.bc, P, C)
        K = fplan.tile_ids.shape[1]     # a row shorter than K reads its -1
        short = int(((fplan.tile_ids >= 0).sum(1) < K).sum())
        kernel_row(rows, "stjoin_vote_fused_pruned", launches, err, ms11,
                   join_ms + tail,
                   bound_ms(read_bytes(*reads, Mc)
                            + 4 * (live.shape[0] + short) + P * 4
                            + P * W * 4, K1_OPS_PER_PAIR * fpairs))
    w_r, i_r = run_refine(pw, pi, ref_t, M, params.delta_t)
    del pw, pi
    tail = time_ms(lambda: plain_out.append(scatter_raw(
        w_r.view(n_plain, M, C), i_r.view(n_plain, M, C),
        slot_ids(sub[:n_plain], ms_, nS), gid, nS, S)), reps=1, warmup=0)
    praw = plain_out.pop()
    err = float((raw[:nS] - praw).abs().max())
    check(torch.equal(raw[:nS], praw),
          f"{name}: K12 not bitwise its plain version on {rng} (max err "
          f"{err})")
    if timed:
        kernel_row(rows, "stjoin_sim_fused_pruned", launches, err, ms12,
                   join_ms + tail,
                   bound_ms(read_bytes(*reads, Mc, gids=True)
                            + 8 * live.shape[0] + S * S * 4,
                            K1_OPS_PER_PAIR * fpairs))
        log(f"  K11 / K12 plain = the pruned plain join {join_ms:.1f} ms + "
            f"their tails; {live.shape[0]} live entries, {fpairs} needed "
            "pairs in kept tiles; library none")
    del w_r, i_r, praw, kv, kwords

    # ---- K13 against K7, every panel (each call timed) ---------------------
    Sb = plan_panel(S)
    swept = {"K13": 0.0, "K7": 0.0}

    def timed_panel(key, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = sj.stjoin_sim_panel_fused(batch, batch, sub, sub, ms_, *eps,
                                        p0=p0, panel=Sb, **kw)
        end.record()
        end.synchronize()
        swept[key] += start.elapsed_time(end)
        return out

    for p0 in range(0, S, Sb):
        f13, r13 = timed_panel("K13", tile_ids=fplan)
        f7, r7 = timed_panel("K7")
        check(torch.equal(f13, f7) and torch.equal(r13, r7),
              f"{name}: K13 panel {p0} not bitwise K7's")
        check(torch.equal(f13, raw[p0:p0 + Sb])
              and torch.equal(r13, raw.T[p0:p0 + Sb]),
              f"{name}: K13 panel {p0} not bitwise K12's raw")
    del raw, f7, r7
    log(f"{name}: K10 bitwise K1, K11 bitwise K2 (vote, words), K12 bitwise "
        f"K4, K13 bitwise K7 on all {S // Sb} panels; all panels, one call "
        f"each (CUDA events, wrapper included): K13 {swept['K13']:.1f} ms, "
        f"K7 {swept['K7']:.1f} ms")

    # ---- K13 against its plain version, one panel in the middle ------------
    p0 = (S // Sb // 2) * Sb
    plain_out = []
    plain = time_ms(lambda: plain_out.append(stjoin_sim_panel_fused_ref(
        *ref_ops, gid.view(-1), *cand_ops, gid, *eps, M=M, n_src=S,
        n_dst=S, p0=p0, panel=Sb, tiles=tiles)), reps=1, warmup=0)
    pf, pr = plain_out.pop()
    f13, r13 = sj.stjoin_sim_panel_fused(batch, batch, sub, sub, ms_, *eps,
                                         p0=p0, panel=Sb, tile_ids=fplan)
    err = max(float((f13 - pf).abs().max()), float((r13 - pr).abs().max()))
    check(torch.equal(f13, pf) and torch.equal(r13, pr),
          f"{name}: K13 not bitwise its plain version on panel {p0} (max "
          f"err {err})")
    log(f"{name}: K10, K11, K12 bitwise their plain versions on {rng}, K13 "
        f"on panel [{p0}, {p0 + Sb})")
    if timed:
        ms = time_ms(lambda: sj.stjoin_sim_panel_fused(
            batch, batch, sub, sub, ms_, *eps, p0=p0, panel=Sb,
            tile_ids=fplan), reps=10)
        # the panel's live entries, sliced as the wrapper slices them
        t_lo, t_hi = p0 // ms_, (p0 + Sb - 1) // ms_
        fwd_pairs, blocks = fplan.by_row
        rev_pairs, tile_of = fplan.by_tile
        f0, f1 = (int(i) for i in blocks.searchsorted([t_lo, t_hi + 1]))
        r0, r1 = (int(i) for i in tile_of.searchsorted(
            [t_lo // fplan.bc, t_hi // fplan.bc + 1]))
        fp, fc = live_reads(fwd_pairs[f0:f1], M, fplan.bc, P, C)
        rp, rc = live_reads(rev_pairs[r0:r1], M, fplan.bc, P, C,
                            cands=(t_lo, t_hi))
        pairs = (kept_window_pairs(batch, params.eps_t, fplan.tile_ids, M,
                                   fplan.bc, rows=(t_lo, t_hi))
                 + kept_window_pairs(batch, params.eps_t, fplan.tile_ids, M,
                                     fplan.bc, cands=(t_lo, t_hi)))
        nbytes = (read_bytes(fp | rp, fc | rc, Mc, gids=True)
                  + 8 * (f1 - f0 + r1 - r0) + 2 * Sb * S * 4)
        kernel_row(rows, "stjoin_sim_panel_fused_pruned", launches, err, ms,
                   plain, bound_ms(nbytes, K1_OPS_PER_PAIR * pairs))
        log(f"  K13 panel [{p0}, {p0 + Sb}): {f1 - f0} forward and "
            f"{r1 - r0} reverse live entries, {int((fp | rp).sum())} "
            f"reference points and {int((fc | rc).sum())} candidates read, "
            f"{pairs} needed pairs; library none")


def phase_index(dev, report, batch, params, name: str, outs=None):
    """The three pruned paths on one batch (and, without ``outs``, the
    three unpruned ones first), their outputs compared; returns each
    kernel's launch count in the pruned run of its path (K11 runs in two
    paths, once in each) and the fused segmentation."""
    outs = dict(outs or {})
    for path in PRUNED_PATHS:
        if path not in outs:
            outs[path] = phase_main(dev, report, path, name=name,
                                    data=(batch, params))[2]
    pouts, launches = {}, {}
    for path in PRUNED_PATHS:
        _, _, pouts[path], n = phase_main(dev, report, path + "+index",
                                          name=name, data=(batch, params))
        for k, v in n.items():      # a kernel's count in its path's run
            launches[k] = max(launches.get(k, 0), v)
    same_pruned(outs, pouts, name)
    return launches, pouts["fused"].seg.sub_local


def phase_main(dev, report, mode: str, n_vessels: int = 4096,
               name: str = "dsc_brest", data=None):
    """One main path at full size (``data``: its ``(batch, params)``, else
    ``brest_batch(n_vessels)``); launch counts read around it.  Peak
    memory is the run's own: the peak allocation above what was
    allocated just before it."""
    from repro_torch import kernels
    from repro_torch.core.dsc import run_dsc
    batch, params = data or brest_batch(n_vessels, dev)
    T, M = batch.x.shape
    log(f"main path ({mode}): {name} T={T} M={M} "
        f"S={T * params.max_subtrajs_per_traj} "
        f"eps_sp={params.eps_sp:.6g} eps_t={params.eps_t:.6g}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_dsc(batch, params, plan=kernel_plan(mode), device=dev,
                  stage_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    ran = {k for k, n in launches.items() if n > 0}
    check(ran == PATH_KERNELS[mode],
          f"{mode} path launched {sorted(ran)}, expected "
          f"{sorted(PATH_KERNELS[mode])}")
    if "_topk" in mode:
        from repro_torch.core.similarity import plan_panel
        S = out.table.num_slots
        want = {"topk_round_scan": out.rounds,
                "topk_claim_max": out.dispatches}
        for panel in ("stjoin_sim_panel_fused",
                      "stjoin_sim_panel_fused_pruned"):
            if panel in ran:
                want[panel] = out.dispatches * S // plan_panel(S)
        check(out.sim is None and peak < S * S * 4,
              f"{mode}: a [S, S] matrix was built (peak {peak} B)")
    else:
        want = {"round_scan": out.rounds}
    for k in ran - set(want):
        want[k] = 1
    check(all(launches[k] == n for k, n in want.items()),
          f"{mode} path: launches {launches}, expected {want}")
    check_output(out, batch, params)
    r = out.result
    members = int((~r.is_rep & (r.member_of >= 0)).sum())
    log("stage ms (CUDA events): " + ", ".join(
        f"{k}={v:.3f}" for k, v in times.items()))
    topk_k = None if out.sim_topk is None else out.sim_topk.k
    log(f"main path ({mode}, {name}) wall s={wall:.3f} rounds={out.rounds} "
        f"dispatches={out.dispatches} final_K={topk_k} "
        f"peak_alloc_GB={peak / 1e9:.3f} clusters={int(r.is_rep.sum())} "
        f"members={members} outliers={int(r.is_outlier.sum())} "
        f"alpha={float(r.alpha_used):.6g} k={float(r.k_used):.6g}")
    log(f"launches: {launches}")
    report[f"{name}_{mode}"] = dict(
        stage_ms=times, wall_s=wall, rounds=out.rounds,
        dispatches=out.dispatches, final_k=topk_k,
        peak_alloc_bytes=peak, clusters=int(r.is_rep.sum()),
        members=members, outliers=int(r.is_outlier.sum()),
        launches=launches)
    return batch, params, out, launches


def kernel_row(rows, name, launches, err, ms, plain, bound, lib=None):
    b, by = bound
    rows.append({"name": name, "route": "cuda",
                 "source": CSRC + SOURCES.get(name, "dsc_kernels.cu"),
                 "replaces": REPLACES[name], "launches": launches[name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": b, "bound_by": by, "library_ms": lib})
    log(f"  {name}: err={err} ms={ms:.4f} plain_ms={plain:.4f} "
        f"bound_ms={b:.4f} ({by}) library_ms={lib}")


def join_input_bytes(P: int, C: int, Mc: int) -> int:
    """Reference x, y, t, id (f32 / i32) and ok (bool) per point;
    candidate x, y, t, ok per point and one id per trajectory."""
    return P * (4 * 4 + 1) + C * Mc * (3 * 4 + 1) + C * 4


def phase_kernels(batch, params, out, launches, rows):
    """K1, K3, K5 and K6 against their plain versions on the materialize
    path's inputs.  Returns K1's plain output and time for the fused
    kernels' plain versions."""
    from repro_torch.core import voting
    from repro_torch.core.clustering import visit_order
    from repro_torch.core.segmentation import tsa2_signal
    from repro_torch.kernels.cluster.ops import (cluster_assign,
                                                 cluster_round_scan)
    from repro_torch.kernels.cluster.ref import (claim_max_ref,
                                                 round_scan_ref)
    from repro_torch.kernels.jaccard.ops import window_jaccard
    from repro_torch.kernels.stjoin.ops import stjoin_best_match
    from repro_torch.kernels.stjoin.ref import stjoin_ref
    T, M = batch.x.shape
    C, Mc = T, M
    P = T * M

    # ---- K1: the full [P, C] join, kernel and plain ----------------------
    ref_ops = (batch.x.reshape(-1), batch.y.reshape(-1), batch.t.reshape(-1),
               batch.traj_id[:, None].expand(T, M).reshape(-1).contiguous(),
               batch.valid.reshape(-1), batch.x, batch.y, batch.t,
               batch.traj_id, batch.valid, params.eps_sp, params.eps_t)
    kw, ki = stjoin_best_match(*ref_ops)
    ms = time_ms(lambda: stjoin_best_match(*ref_ops, out_w=kw, out_idx=ki),
                 reps=3)
    plain_out = []
    k1_plain = time_ms(lambda: plain_out.append(stjoin_ref(*ref_ops)),
                       reps=1, warmup=0)
    pw, pi = plain_out.pop()
    check(torch.equal(ki, pi), "K1 best_idx differs from the plain version")
    err = float((kw - pw).abs().max())
    check(torch.equal(kw, pw), f"K1 best_w not bitwise (max err {err})")
    matched = int((ki >= 0).sum())
    needed = k1_window_pairs(batch, params.eps_t)
    kernel_row(rows, "stjoin_best_match", launches, err, ms, k1_plain,
               bound_ms(join_input_bytes(P, C, Mc) + 8 * P * C,
                        K1_OPS_PER_PAIR * needed))
    sweep_ms = K1_OPS_PER_PAIR * P * C * Mc / F32_OPS_PER_S * 1e3
    log(f"  K1 pairs swept={P * C * Mc} needed (|dt| <= eps_t)={needed} "
        f"matched (p, c)={matched}; the full sweep's f32 floor "
        f"{sweep_ms:.4f} ms")

    # ---- K3: the packed TSA2 words of that join --------------------------
    from repro_torch.core.types import JoinResult
    words = voting.neighbor_mask_packed(
        JoinResult(best_w=kw.view(T, M, C), best_idx=ki.view(T, M, C)))
    del kw, ki
    masked = torch.where(batch.valid[..., None], words, 0)
    kd = window_jaccard(words, batch.valid, w=params.w)
    pd = tsa2_signal(masked, params.w)
    err = float((kd - pd).abs().max())
    check(torch.equal(kd, pd), f"K3 d not bitwise (max err {err})")
    ms = time_ms(lambda: window_jaccard(masked, batch.valid, w=params.w),
                 reps=10)
    plain = time_ms(lambda: tsa2_signal(masked, params.w), reps=3)
    W = words.shape[-1]
    kernel_row(rows, "jaccard_window", launches, err, ms, plain,
               bound_ms(T * M * W * 4 + T * M * 5))
    del words, masked

    # ---- K5 / K6: the main path's [S, S] matrix and round states ---------
    sim, table, alpha = out.sim, out.table, out.result.alpha_used
    S = sim.shape[0]
    order, rank = visit_order(table)
    potential = table.valid & (table.voting >= out.result.k_used)
    states = [(potential.clone(), torch.zeros_like(potential))]
    b, c = cluster_round_scan(sim, rank, *states[0], alpha)
    frontier = states[0][0] & (~b | c)
    states.append((states[0][0] & ~frontier, frontier & ~c))
    states.append((torch.zeros_like(potential), out.result.is_rep.clone()))
    for unres, rep in states:
        kb, kc = cluster_round_scan(sim, rank, unres, rep, alpha)
        pb, pc = round_scan_ref(sim, rank, unres, rep, alpha)
        check(torch.equal(kb, pb) and torch.equal(kc, pc),
              "K5 differs from the plain version")
    unres, rep = states[0]
    active = int((unres | rep).sum())
    ms = time_ms(lambda: cluster_round_scan(sim, rank, unres, rep, alpha))
    plain = time_ms(lambda: round_scan_ref(sim, rank, unres, rep, alpha),
                    reps=3)
    predf = ((sim > 0.0) & (sim >= alpha)
             & (rank[:, None] < rank[None, :])).to(torch.float32)
    uf = unres.to(torch.float32)
    lib = time_ms(lambda: uf @ predf)
    del predf
    kernel_row(rows, "round_scan", launches, 0.0, ms, plain,
               bound_ms(active * S * 4.0 + S * 6 + S * 2), lib)
    log(f"  K5 timed at round 0: {active} active rows of {S}")

    rep = out.result.is_rep
    kw6, ks6 = cluster_assign(sim, rank, rep, table.valid, alpha)
    pw6, ps6 = claim_max_ref(sim, order, rank, rep, table.valid, alpha)
    err = float((kw6 - pw6).abs().max())
    check(torch.equal(ks6, ps6), "K6 best_slot differs")
    check(torch.equal(kw6, pw6), f"K6 best_w not bitwise (max err {err})")
    n_rep = int(rep.sum())
    ms = time_ms(lambda: cluster_assign(sim, rank, rep, table.valid, alpha))
    plain = time_ms(lambda: claim_max_ref(sim, order, rank, rep, table.valid,
                                          alpha), reps=3)
    kernel_row(rows, "claim_max", launches, err, ms, plain,
               bound_ms(n_rep * S * 4.0 + S * 6 + S * 8))
    log(f"  K6 timed on the final {n_rep} representative rows")
    return pw, pi, k1_plain


def phase_fused_kernels(batch, params, fout, launches, pw, pi, k1_plain,
                        rows):
    """K2 and K4 against their plain versions on the fused path's inputs.
    The plain versions start from K1's plain output (the same join), so
    their time is K1's plain time plus that of the refine and the
    consumer.  No single PyTorch call computes either function (a best
    match, a run refine and a sum or a keyed scatter in one), so neither
    has a library time."""
    from repro_torch.kernels.stjoin import ops as sj
    from repro_torch.core.similarity import scatter_raw, slot_ids
    from repro_torch.kernels.stjoin.ref import run_refine, vote_words_ref
    T, M = batch.x.shape
    C, Mc = T, M
    P = T * M
    ms_ = params.max_subtrajs_per_traj
    S = T * ms_
    arrs = (batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2
    eps = (params.eps_sp, params.eps_t, params.delta_t)
    ref_t = batch.t.reshape(-1)
    ops = K1_OPS_PER_PAIR * k1_window_pairs(batch, params.eps_t)
    sweep_ms = K1_OPS_PER_PAIR * P * C * Mc / F32_OPS_PER_S * 1e3

    # ---- K2: vote sums and packed words ----------------------------------
    kv, kw = sj.stjoin_vote_fused_arrays(*arrs, *eps)
    ms = time_ms(lambda: sj.stjoin_vote_fused_arrays(*arrs, *eps), reps=3)
    plain_out = []
    tail = time_ms(lambda: plain_out.append(vote_words_ref(
        run_refine(pw, None, ref_t, M, params.delta_t)[0])), reps=1,
        warmup=0)
    pv, pwords = plain_out.pop()
    check(torch.equal(kw.view(P, -1), pwords),
          "K2 words differ from the plain version")
    err = float((kv.view(-1) - pv).abs().max())
    check(torch.equal(kv.view(-1), pv), f"K2 vote not bitwise (max err {err})")
    W = pwords.shape[1]
    kernel_row(rows, "stjoin_vote_fused", launches, err, ms, k1_plain + tail,
               bound_ms(join_input_bytes(P, C, Mc) + P * 4 + P * W * 4, ops))
    log(f"  K2 plain = K1 plain {k1_plain:.1f} ms + refine, vote and words "
        f"{tail:.1f} ms; full-sweep floor {sweep_ms:.4f} ms; library none")
    del kv, kw, pv, pwords

    # ---- K4: the raw similarity scatter ----------------------------------
    sub = fout.seg.sub_local
    raw = sj.stjoin_sim_fused(batch, batch, sub, sub, ms_, *eps)
    ms = time_ms(lambda: sj.stjoin_sim_fused(batch, batch, sub, sub, ms_,
                                             *eps), reps=3)
    w_r, i_r = run_refine(pw, pi, ref_t, M, params.delta_t)
    gid = slot_ids(sub, ms_, S)
    plain_out = []
    tail = time_ms(lambda: plain_out.append(scatter_raw(
        w_r.view(T, M, C), i_r.view(T, M, C), gid, gid, S, S)), reps=1,
        warmup=0)
    praw = plain_out.pop()
    err = float((raw - praw).abs().max())
    check(torch.equal(raw, praw), f"K4 raw not bitwise (max err {err})")
    kernel_row(rows, "stjoin_sim_fused", launches, err, ms, k1_plain + tail,
               bound_ms(join_input_bytes(P, C, Mc) + P * 4 + C * Mc * 4
                        + S * S * 4, ops))
    log(f"  K4 plain = K1 plain {k1_plain:.1f} ms + refine and scatter "
        f"{tail:.1f} ms; {int((praw > 0).sum())} nonzero cells of {S * S}; "
        f"full-sweep floor {sweep_ms:.4f} ms; library none")
    return raw


def phase_topk_kernels(batch, params, tout, launches, raw, rows):
    """K7, K8 and K9 against their plain versions on the fused top-K
    path's inputs: K7 on one panel (also bitwise against K4's ``raw``), K8
    and K9 on the final lists.  No single PyTorch call computes any of
    them: K7 is a best match, a run refine and a keyed scatter in two
    orientations; K8 and K9 gather rank and state at the list ids and
    reduce each row by a predicate or a two-key (weight, rank) order."""
    from repro_torch.core.clustering import visit_order
    from repro_torch.core.similarity import (finalize_sim_panel, plan_panel,
                                             sim_row_moments, slot_ids,
                                             topk_reduce_rows)
    from repro_torch.kernels.cluster.ops import (topk_cluster_assign,
                                                 topk_cluster_round_scan)
    from repro_torch.kernels.cluster.ref import (topk_claim_max_ref,
                                                 topk_round_scan_ref)
    from repro_torch.kernels.stjoin import ops as sj
    from repro_torch.kernels.stjoin.ref import stjoin_sim_panel_fused_ref
    T, M = batch.x.shape
    ms_ = params.max_subtrajs_per_traj
    S = T * ms_
    Sb = plan_panel(S)
    eps = (params.eps_sp, params.eps_t, params.delta_t)

    # ---- K7: one panel in the middle, both slabs -------------------------
    sub = tout.seg.sub_local
    p0 = (S // Sb // 2) * Sb
    fwd, rev = sj.stjoin_sim_panel_fused(batch, batch, sub, sub, ms_, *eps,
                                         p0=p0, panel=Sb)
    ms = time_ms(lambda: sj.stjoin_sim_panel_fused(
        batch, batch, sub, sub, ms_, *eps, p0=p0, panel=Sb), reps=10)
    ref_ops, cand_ops = sj._flat_operands(
        *(batch.x, batch.y, batch.t, batch.valid, batch.traj_id) * 2)
    gid = slot_ids(sub, ms_, S)
    plain_out = []
    plain = time_ms(lambda: plain_out.append(stjoin_sim_panel_fused_ref(
        *ref_ops, gid.view(-1), *cand_ops, gid, *eps, M=M, n_src=S,
        n_dst=S, p0=p0, panel=Sb)), reps=1, warmup=0)
    pf, pr = plain_out.pop()
    err = max(float((fwd - pf).abs().max()), float((rev - pr).abs().max()))
    check(torch.equal(fwd, pf) and torch.equal(rev, pr),
          f"K7 slabs not bitwise the plain version (max err {err})")
    check(torch.equal(fwd, raw[p0:p0 + Sb])
          and torch.equal(rev, raw.T[p0:p0 + Sb]),
          "K7 slabs not bitwise K4's raw rows / transposed columns")
    partners = window_partners(batch, params.eps_t)
    t_lo, t_hi = p0 // ms_, (p0 + Sb - 1) // ms_
    pairs = 2 * int(partners[t_lo:t_hi + 1].sum())
    P, C, Mc = T * M, T, M
    kernel_row(rows, "stjoin_sim_panel_fused", launches, err, ms, plain,
               bound_ms(join_input_bytes(P, C, Mc) + P * 4 + C * Mc * 4
                        + 2 * Sb * S * 4, K1_OPS_PER_PAIR * pairs))
    log(f"  K7 panel [{p0}, {p0 + Sb}): rows {t_lo}..{t_hi}, "
        f"{pairs} needed pairs, {int((pf > 0).sum())} + "
        f"{int((pr > 0).sum())} nonzero cells; library none")
    tk, table = tout.sim_topk, tout.table

    def panel_tail():
        sim_rows = finalize_sim_panel(fwd, rev, p0, table)
        sim_row_moments(sim_rows, table.valid[p0:p0 + Sb], table.valid)
        return topk_reduce_rows(sim_rows, tk.k)

    log(f"  the rest of one panel at the final K={tk.k} (finalize, row "
        f"moments, stable sort): {time_ms(panel_tail, reps=10):.4f} ms")
    del fwd, rev, pf, pr

    # ---- K8 / K9: the final [S, K] lists and round states ----------------
    alpha = tout.result.alpha_used
    K = tk.k
    _, rank = visit_order(table)
    potential = table.valid & (table.voting >= tout.result.k_used)
    states = [(potential.clone(), torch.zeros_like(potential))]
    b, c = topk_cluster_round_scan(tk.ids, tk.sims, rank, *states[0], alpha)
    frontier = states[0][0] & (~b | c)
    states.append((states[0][0] & ~frontier, frontier & ~c))
    states.append((torch.zeros_like(potential), tout.result.is_rep.clone()))
    for unres, rep in states:
        kb, kc = topk_cluster_round_scan(tk.ids, tk.sims, rank, unres, rep,
                                         alpha)
        pb, pc = topk_round_scan_ref(tk.ids, tk.sims, rank, unres, rep,
                                     alpha)
        check(torch.equal(kb, pb) and torch.equal(kc, pc),
              "K8 differs from the plain version")
    unres, rep = states[0]
    ms = time_ms(lambda: topk_cluster_round_scan(tk.ids, tk.sims, rank,
                                                 unres, rep, alpha))
    plain = time_ms(lambda: topk_round_scan_ref(tk.ids, tk.sims, rank,
                                                unres, rep, alpha), reps=3)
    kernel_row(rows, "topk_round_scan", launches, 0.0, ms, plain,
               bound_ms(S * K * 8.0 + S * 6 + S * 2))
    log(f"  K8 timed at round 0 on the final lists, K={K}")

    rep = tout.result.is_rep
    kw, ks = topk_cluster_assign(tk.ids, tk.sims, rank, rep, table.valid,
                                 alpha)
    pw, ps = topk_claim_max_ref(tk.ids, tk.sims, rank, rep, table.valid,
                                alpha)
    err = float((kw - pw).abs().max())
    check(torch.equal(ks, ps), "K9 best_slot differs")
    check(torch.equal(kw, pw), f"K9 best_w not bitwise (max err {err})")
    ms = time_ms(lambda: topk_cluster_assign(tk.ids, tk.sims, rank, rep,
                                             table.valid, alpha))
    plain = time_ms(lambda: topk_claim_max_ref(tk.ids, tk.sims, rank, rep,
                                               table.valid, alpha), reps=3)
    n_valid = int(table.valid.sum())   # K9 reads only valid rows' lists
    kernel_row(rows, "topk_claim_max", launches, err, ms, plain,
               bound_ms(n_valid * K * 8.0 + S * 6 + S * 8))
    log(f"  K9 timed on the final {int(rep.sum())} representatives, K={K}, "
        f"{n_valid} valid rows of {S}")


# f32 instructions of one LCSS cell: the weight (dx, dy, two products,
# their sum, the square root, dt, its absolute value, two compares) where
# both points are valid, the division and subtraction where they match, and
# one add and three maxima per channel for the DP
LCSS_OPS_VALID, LCSS_OPS_MATCH, LCSS_OPS_DP = 10, 2, 8
LCSS_PARTNERS = 8          # each trajectory is paired with the next 8 rows


def phase_lcss(dev, report, rows):
    """K14 at dsc_brest: the lane-sorted vessels, each paired with the next
    ``LCSS_PARTNERS`` rows (mod T), dsc_brest's eps.  ``lcss_similarity``
    once with the counts read around it; then the kernel bitwise its
    sheared plain twin (every pair), the row scan (the first pairs) and
    itself on the swapped pairs, timed with its bound.  No single PyTorch
    call computes the DP: library none."""
    from repro_torch import kernels
    from repro_torch.kernels.lcss import ops as lo
    from repro_torch.kernels.lcss import ref as lr
    batch, params = brest_batch(4096, dev, sort_by_lane=True)
    T, M = batch.x.shape
    ri = torch.arange(T, device=dev).repeat_interleave(LCSS_PARTNERS)
    si = (ri + torch.arange(1, LCSS_PARTNERS + 1, device=dev)
          .repeat(T)) % T
    cols = (batch.x, batch.y, batch.t, batch.valid)
    ops = [c[ri].contiguous() for c in cols] + [c[si].contiguous()
                                                 for c in cols]
    eps = (params.eps_sp, params.eps_t)
    B = ri.shape[0]
    log(f"lcss (K14): {B} pairs of lane-sorted dsc_brest vessels, N=M={M}, "
        f"eps_sp={params.eps_sp:.6g} eps_t={params.eps_t:.6g}")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sim = lo.lcss_similarity(*ops, *eps, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    ran = {k: n for k, n in launches.items() if n}
    check(ran == {"lcss_wavefront": 1},
          f"lcss_similarity launched {ran}, expected one lcss_wavefront")
    check(sim.shape == (B, 2) and bool(torch.isfinite(sim).all()),
          "lcss: similarity shape or non-finite values")

    got = lo.lcss_wavefront(*ops, *eps)
    n = ops[3].sum(1)
    m = ops[7].sum(1)
    check(bool((got[:, 0] >= 0).all()) and bool((got[:, 0] <= got[:, 1])
                                                .all())
          and bool((got[:, 1] <= torch.minimum(n, m)).all()),
          "lcss: not 0 <= weighted <= count <= min(n, m)")
    check(torch.equal(lo.lcss_wavefront(*ops[4:], *ops[:4], *eps), got),
          "lcss: the swapped pairs score differently")
    head = [o[:64] for o in ops]
    check(torch.equal(lr.lcss_ref(*head, *eps), got[:64]),
          "lcss: K14 not bitwise the row scan on the first 64 pairs")
    ms = time_ms(lambda: lo.lcss_wavefront(*ops, *eps), reps=10)
    out = []
    plain = time_ms(lambda: out.append(lr.lcss_wavefront_ref(
        lr.shear_weights(*ops, *eps))), reps=1, warmup=0)
    twin = out.pop()
    err = float((got - twin).abs().max())
    check(torch.equal(got, twin),
          f"lcss: K14 not bitwise its sheared plain twin (max err {err})")
    del twin, out
    torch.cuda.empty_cache()
    wu = lr.match_weights(*ops, *eps)
    matched = int((wu[:, 1] > 0).sum())
    del wu
    valid_cells = int((n * m).sum())
    cells = B * M * M
    op_count = (LCSS_OPS_VALID * valid_cells + LCSS_OPS_MATCH * matched
                + LCSS_OPS_DP * cells)
    nbytes = B * 2 * M * 13 + B * 2 * 4
    kernel_row(rows, "lcss_wavefront", launches, err, ms, plain,
               bound_ms(nbytes, op_count))
    nz = int((got[:, 1] > 0).sum())
    log(f"  K14: {cells} cells, {valid_cells} with both points valid, "
        f"{matched} matching; {nz} of {B} pairs share a point; mean "
        f"similarity (weighted, count) {sim.mean(0).tolist()}; the entry "
        f"point's run {wall * 1e3:.3f} ms (host clock); library none")
    report["lcss"] = dict(pairs=B, N=M, M=M, cells=cells,
                          valid_cells=valid_cells, matched=matched,
                          sharing_pairs=nz, ms=ms, plain_ms=plain,
                          wall_ms=wall * 1e3, launches=launches)


# (name, dtype, B, L query, M keys, KV, G, hd, mask, softcap, q scale) at
# the shapes of configs/smollm_360m.py and configs/gemma2_2b.py, and one
# head dim past the fast paths' 256.  The decode step attends keys [0,
# 6000] of an 8192-slot cache.  With q scaled by
# hd**-0.5 the scores are about N(0, 1) and a softcap of 50 does nothing,
# so the last case leaves q unscaled (scores about N(0, hd)): there tanh
# bends the scores, in float32, where a flipped bfloat16 rounding of a
# score would not swamp the check
ATTN_CASES = (
    ("smollm-360m prefill f32", torch.float32, 1, 4096, 4096, 5, 3, 64,
     dict(), None, 64 ** -0.5),
    ("smollm-360m prefill bf16", torch.bfloat16, 1, 4096, 4096, 5, 3, 64,
     dict(), None, 64 ** -0.5),
    ("gemma2-2b local prefill bf16", torch.bfloat16, 1, 8192, 8192, 4, 2,
     256, dict(window=4096), 50.0, 256 ** -0.5),
    ("gemma2-2b decode bf16", torch.bfloat16, 1, 1, 8192, 4, 2, 256,
     dict(max_kv=6000), 50.0, 256 ** -0.5),
    ("gemma2-2b local prefill f32, q unscaled", torch.float32, 1, 8192,
     8192, 4, 2, 256, dict(window=4096), 50.0, 1.0),
    ("hd-512 general bf16", torch.bfloat16, 1, 1024, 1024, 2, 2, 512,
     dict(window=256), None, 512 ** -0.5),
)


def attention_inputs(dev, case, seed):
    """q (times the case's scale; the models scale it by hd**-0.5), k, v
    from a seed; positions; the mask arguments."""
    _, dtype, B, Lq, M, KV, G, hd, mask, _, q_scale = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Lq, KV, G, hd), generator=g, device=dev) * q_scale
    k = torch.randn((B, M, KV, hd), generator=g, device=dev)
    v = torch.randn((B, M, KV, hd), generator=g, device=dev)
    qp = torch.arange(M - Lq, M, dtype=torch.int32, device=dev)
    if "max_kv" in mask:
        qp = torch.full((1,), mask["max_kv"], dtype=torch.int32, device=dev)
    kp = torch.arange(M, dtype=torch.int32, device=dev)
    return [t.to(dtype) for t in (q, k, v)], qp, kp


def phase_attention(dev, report, rows):
    """K15 at the models' shapes: ``flash_attention`` once per case with the
    counts read around those calls; then each case's path and tile counts
    (a second call, bitwise the first, counting the tiles it swept and
    skipped against ``tile_class_ref``), the case against the plain
    version (within ``kernel_tolerance``; the largest share of it used is
    logged) and timed with its bound, per call (``time_ms``) and as
    device time (``graph_ms``, replayed from a CUDA graph); the smollm
    cases beside ``scaled_dot_product_attention(is_causal=True)`` on the
    same values laid out as it takes them (the layout change untimed).
    The JSON row is the float32 smollm case; the others are logged."""
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.attention import ops as ao
    from repro_torch.kernels.attention.ref import (attention_mask,
                                                   flash_attention_ref,
                                                   kernel_tolerance,
                                                   tile_class_ref)
    inputs = [attention_inputs(dev, c, i) for i, c in enumerate(ATTN_CASES)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    outs = [ao.flash_attention(q, k, v, qp, kp, softcap=c[9], device=dev,
                               **c[8])
            for c, ((q, k, v), qp, kp) in zip(ATTN_CASES, inputs)]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    ran = {k: n for k, n in launches.items() if n}
    check(ran == {"flash_attention_fwd": len(ATTN_CASES)},
          f"flash_attention launched {ran}, expected "
          f"{len(ATTN_CASES)} flash_attention_fwd")
    report["attention"] = {}
    for case, ((q, k, v), qp, kp), got in zip(ATTN_CASES, inputs, outs):
        name, dtype, B, Lq, M, KV, G, hd, mask, cap, _ = case
        args = (mask.get("window", ao.HUGE), mask.get("prefix", 0),
                mask.get("max_kv", ao.HUGE))
        check(got.shape == q.shape and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"{name}: output shape, dtype or non-finite values")
        plan = ao.plan_for(q, k, v)
        stats = torch.zeros(2, dtype=torch.int32, device=dev)
        again = ao.flash_attention_fwd(q, k, v, qp, kp, *args, softcap=cap,
                                       stats=stats)
        check(torch.equal(again, got), f"{name}: K15 not bitwise repeatable")
        del again
        cls = tile_class_ref(qp, kp, *args, G=G, rows=plan.rows,
                             keys=plan.keys)
        swept, skipped = stats.tolist()
        mirror = [cls.numel() * B * KV, int((cls == 0).sum()) * B * KV]
        check([swept, skipped] == mirror,
              f"{name}: K15 swept / skipped {swept} / {skipped} tiles, the "
              f"mirror {mirror[0]} / {mirror[1]}")
        kname = k15_kernel(plan, hd, dtype)
        log(f"  {name}: path {plan.path} ({plan.rows} rows x {plan.keys} "
            f"keys a tile, {plan.nsplit} key splits of "
            f"{plan.tiles_per_split} tiles); skipped {skipped} of {swept} "
            f"(row block, tile) pairs, as the mirror; "
            f"{int((cls == 2).sum()) * B * KV} fully kept; ptxas {kname}: "
            f"{PTXAS.get(kname, 'not built in this run')}")
        res = []            # warmed: a cold first call spreads 3x
        plain = time_ms(lambda: res.append(flash_attention_ref(
            q, k, v, qp, kp, *args, softcap=cap)), reps=3)
        want = res.pop()
        ok = attention_mask(qp, kp, *args)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        share = diff / kernel_tolerance(q, k, v, qp, kp, *args, cap, want)
        used, at = share.reshape(-1).max(0)
        used, at = float(used), int(at)
        row = at // (KV * G * hd) % Lq
        log(f"  {name}: {used:.4g} of the tolerance used, most at query "
            f"{row} ({int(ok[row].sum())} keys kept; K15 "
            f"{float(got.reshape(-1)[at]):.6g}, plain "
            f"{float(want.reshape(-1)[at]):.6g})")
        check(used <= 1.0,
              f"{name}: K15 outside its tolerance of the plain version "
              f"(max err {err}, {used:.3g} of the tolerance)")
        if dtype == torch.bfloat16:     # each against float32 arithmetic
            exact = flash_attention_ref(q.float(), k.float(), v.float(), qp,
                                        kp, *args, softcap=cap)
            log(f"  {name}: max |K15 - f32| = "
                f"{float((got.float() - exact).abs().max())}, max |plain - "
                f"f32| = {float((want.float() - exact).abs().max())}")
            del exact
        del want, res, diff, share
        if cap:             # how far the scores reach into the softcap
            s = torch.einsum("blkgh,bmkh->blkgm", q[:, -256:].float(),
                             k.float())
            log(f"  {name}: max |q.k| over the last 256 query rows = "
                f"{float(s.abs().max()):.4g} (softcap {cap})")
            del s
        call = lambda: ao.flash_attention_fwd(q, k, v, qp, kp, *args,
                                              softcap=cap)
        ms = time_ms(call, reps=20, warmup=3)
        dev_ms = graph_ms(call)
        pairs = int(ok.sum())                       # unmasked
        flops = 4 * hd * pairs * B * KV * G
        # k and v of the keys some row keeps (of all, if a row keeps none:
        # it averages every v), q in and out, the positions
        keys = int(ok.any(0).sum()) if bool(ok.any(1).all()) else M
        esize = q.element_size()
        nbytes = 2 * q.numel() * esize + 2 * B * keys * KV * hd * esize \
            + 4 * (Lq + M)
        rate = F32_FLOPS_PER_S if dtype == torch.float32 else \
            BF16_FLOPS_PER_S
        bound = bound_ms(nbytes, flops, rate)
        lib = None
        if name.startswith("smollm"):
            H = KV * G
            qs = q.reshape(B, Lq, H, hd).transpose(1, 2).contiguous()
            ks, vs = (t.repeat_interleave(G, dim=2).transpose(1, 2)
                      .contiguous() for t in (k, v))
            sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                  scale=1.0)
            lerr = float((sdpa.transpose(1, 2).reshape(q.shape).float()
                          - got.float()).abs().max())
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, scale=1.0), reps=3)
            del qs, ks, vs, sdpa
            log(f"  {name}: max |K15 - SDPA| = {lerr}")
        log(f"  {name}: B={B} Lq={Lq} M={M} KV={KV} G={G} hd={hd} "
            f"mask={mask} softcap={cap}: err={err} ms={ms:.4f} "
            f"plain_ms={plain:.4f} bound_ms={bound[0]:.4f} ({bound[1]}; "
            f"{pairs} unmasked pairs, {keys} keys read, {flops:.4g} flops) "
            f"tolerance_used={used:.4g} library_ms={lib} "
            f"graph_ms={dev_ms:.4f} (device time, replayed)")
        report["attention"][name] = dict(
            err=err, tolerance_used=used, ms=ms, graph_ms=dev_ms,
            plain_ms=plain,
            path=plan.path, nsplit=plan.nsplit, tiles_swept=swept,
            tiles_skipped=skipped,
            bound_ms=bound[0], bound_by=bound[1], library_ms=lib,
            pairs=pairs, keys=keys, flops=flops)
        if name == ATTN_CASES[0][0]:
            kernel_row(rows, "flash_attention_fwd", launches, err, ms, plain,
                       bound, lib)
    del outs, inputs


def kernel_name(line: str) -> str | None:
    """The kernel a ptxas ``Function properties for <mangled>`` line is
    about: the ``<length><name>`` of the mangled name that ends in
    ``_kernel`` (its template arguments in their mangled form), or None."""
    mangled = line.split("Function properties for", 1)[1].strip()
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):        # a length may follow digits
            n, at = int(digits[i:]), m.end()
            name = mangled[at:at + n]
            if len(name) == n and name.endswith("_kernel"):
                t = re.match(r"I(\w+?)EE", mangled[at + n:])
                return name + (f"<{t.group(1)}>" if t else "")
    return None


# ptxas' registers and spills of each kernel instantiation, by name (empty
# when the library was already built)
PTXAS: dict[str, str] = {}


def log_ptxas(build_log: str) -> None:
    """One line per kernel from ``nvcc --ptxas-options=-v``: its
    registers and spills (nothing when the library was already built)."""
    name, spill = None, ""
    for line in build_log.splitlines():
        if "Function properties for" in line:
            name = kernel_name(line)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            PTXAS[name] = f"{line.split(':', 1)[1].strip()}; {spill}"
            log(f"  ptxas: {name}: {PTXAS[name]}")
        elif "error" in line:
            log("  ptxas: " + line.strip())


def k15_kernel(plan, hd: int, dtype) -> str:
    """The ptxas name of the kernel instantiation a K15 plan launches."""
    if plan.path == "general":
        return "attn_general_kernel<" + ("f>" if dtype == torch.float32
                                         else "13__nv_bfloat16>")
    hd_class = 64 if hd <= 64 else 128 if hd <= 128 else 256
    return f"attn_{plan.path}_kernel<Li{hd_class}ELi{plan.keys}>"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every number to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    kernels.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s into {kernels.build_dir()}")
    if kernels.build_seconds:       # a fresh build: one nvcc per source
        steps = kernels.build_seconds
        log("  build steps (s): " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in steps.items())
            + f"; one after another {sum(steps.values()):.1f}")
    log_ptxas(kernels.build_log)
    report = {"card": card, "build_s": build_s,
              "build_steps_s": kernels.build_seconds}

    phase_parity(dev)
    phase_parity_fused(dev)
    phase_parity_topk(dev)
    phase_parity_index(dev)
    batch, params, out, launches = phase_main(dev, report, "materialize")
    _, _, fout, flaunches = phase_main(dev, report, "fused")
    same_labels(fout, out, "dsc_brest: fused vs materialize path")
    sim_diff = float((out.sim - fout.sim).abs().max())
    log(f"dsc_brest: fused labels equal the materialize labels; "
        f"max |sim fused - sim materialize| = {sim_diff}")
    _, _, tout, tlaunches = phase_main(dev, report, "fused_topk")
    same_labels(tout, fout, "dsc_brest: fused top-K vs fused dense path")
    same_topk(tout, fout, "dsc_brest: fused top-K")
    check(torch.equal(tout.sscr, fout.sscr), "dsc_brest: top-K sscr")
    log("dsc_brest: fused top-K labels equal the dense fused labels; lists "
        "bitwise topk_from_dense of the dense matrix")
    join_ids, fplan = plan_index(batch, params, report, "dsc_brest")
    _, sub = phase_index(dev, report, batch, params, "dsc_brest",
                         outs=dict(materialize=out, fused=fout,
                                   fused_topk=tout))
    rows = []
    pw, pi, k1_plain = phase_kernels(batch, params, out, launches, rows)
    raw = phase_fused_kernels(batch, params, fout, flaunches, pw, pi,
                              k1_plain, rows)
    phase_topk_kernels(batch, params, tout, tlaunches, raw, rows)
    del out, fout, tout, pw, pi, raw
    torch.cuda.empty_cache()
    phase_pruned_kernels(batch, params, sub, join_ids, fplan, {}, rows,
                         "dsc_brest", n_plain=1024)
    del join_ids, fplan
    sbatch, _ = brest_batch(4096, dev, sort_by_lane=True)
    name = "dsc_brest_lanes"
    join_ids, fplan = plan_index(sbatch, params, report, name)
    ilaunches, sub = phase_index(dev, report, sbatch, params, name)
    torch.cuda.empty_cache()
    phase_pruned_kernels(sbatch, params, sub, join_ids, fplan, ilaunches,
                         rows, name, n_plain=sbatch.num_trajs)
    del sbatch, join_ids, fplan, sub
    torch.cuda.empty_cache()
    _, _, sout, _ = phase_main(dev, report, "fused", n_vessels=8192,
                               name="dsc_sis")
    dense_labels = [getattr(sout.result, f).cpu() for f in LABELS]
    del sout
    torch.cuda.empty_cache()
    _, _, stout, _ = phase_main(dev, report, "fused_topk", n_vessels=8192,
                                name="dsc_sis")
    for f, want in zip(LABELS, dense_labels):
        check(torch.equal(getattr(stout.result, f).cpu(), want),
              f"dsc_sis: fused top-K vs fused dense path: {f} differs")
    log("dsc_sis: fused top-K labels equal the dense fused labels")
    del stout
    torch.cuda.empty_cache()
    phase_lcss(dev, report, rows)
    torch.cuda.empty_cache()
    phase_attention(dev, report, rows)
    order = list(REPLACES)
    rows.sort(key=lambda r: order.index(r["name"]))
    check(len(rows) == len(REPLACES),
          f"{len(rows)} kernel rows, expected {len(REPLACES)}")
    report["kernels"] = rows
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(report, indent=1) + "\n")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
