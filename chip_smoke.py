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

Prints one JSON ``kernels`` line, then the card's name and power limit,
then ``{"ok": true, "device": {...}}`` as the last line.  Any mismatch or
error exits non-zero without the result line; so does a machine without a
card or a directory without the port.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = "src/repro_torch/kernels/csrc/dsc_kernels.cu"
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; f32 outside
# the tensor cores is 67 TFLOP/s counting an FMA as two operations, so
# 33.5e12 f32 instructions per second for code built with -fmad=false
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
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
}
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
}
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


def bound_ms(nbytes: float, ops: float = 0.0):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
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


def brest_batch(n_vessels: int, dev, delta_t: float = 0.0):
    """The launcher's ``dsc_brest`` data and parameters
    (``repro.launch.run_dsc``: eps_sp = 0.15 * diameter, eps_t = mean
    sampling interval, delta_t = 0, w = 20, tau = 0.4, -1 sigma
    thresholds, 8 subtrajectories per trajectory) with TSA2.  The
    launcher's own default for dsc_brest is TSA1 (the registry's
    ``segmentation="tsa1"``); TSA2 is chosen here so that the Jaccard
    kernel runs: the launcher equivalent is ``--config dsc_brest
    --n-trajs 4096 --segmentation tsa2``.  ``dsc_sis`` has the same
    generator and parameters at 8192 vessels."""
    from repro_torch.core.types import DSCParams
    from repro_torch.data.synthetic import ais_like, default_dsc_params_for
    batch, _ = ais_like(n_vessels=n_vessels, max_points=128, n_lanes=8,
                        seed=0, device=dev)
    diam, mean_dt = default_dsc_params_for(batch)
    params = DSCParams(eps_sp=0.15 * diam, eps_t=mean_dt, delta_t=delta_t,
                       w=20, tau=0.4, alpha_sigma=-1.0, k_sigma=-1.0,
                       max_subtrajs_per_traj=8, segmentation="tsa2")
    return batch, params


def kernel_plan(path: str = "materialize"):
    """The kernel plan of a path: ``"materialize"``, ``"fused"``,
    ``"materialize_topk"`` or ``"fused_topk"`` (the default K and panel)."""
    from repro_torch.core.plan import EnginePlan
    mode, _, sim = path.partition("_")
    return EnginePlan(mode=mode, use_kernel=True, seg_use_kernel=True,
                      cluster_use_kernel=True, sim_mode=sim or "dense",
                      cluster_engine="rounds")


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


def phase_main(dev, report, mode: str, n_vessels: int = 4096,
               name: str = "dsc_brest"):
    """One main path at full size; launch counts read around it.  Peak
    memory is the run's own: the peak allocation above what was
    allocated just before it."""
    from repro_torch import kernels
    from repro_torch.core.dsc import run_dsc
    batch, params = brest_batch(n_vessels, dev)
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
    if mode.endswith("_topk"):
        from repro_torch.core.similarity import plan_panel
        S = out.table.num_slots
        want = {"topk_round_scan": out.rounds,
                "topk_claim_max": out.dispatches}
        if "stjoin_sim_panel_fused" in ran:
            want["stjoin_sim_panel_fused"] = (out.dispatches * S
                                              // plan_panel(S))
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
    rows.append({"name": name, "route": "cuda", "source": CSRC,
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
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas: " + line.strip())
    report = {"card": card, "build_s": build_s}

    phase_parity(dev)
    phase_parity_fused(dev)
    phase_parity_topk(dev)
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
    rows = []
    pw, pi, k1_plain = phase_kernels(batch, params, out, launches, rows)
    raw = phase_fused_kernels(batch, params, fout, flaunches, pw, pi,
                              k1_plain, rows)
    phase_topk_kernels(batch, params, tout, tlaunches, raw, rows)
    order = list(REPLACES)
    rows.sort(key=lambda r: order.index(r["name"]))
    del out, fout, tout, pw, pi, raw
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
