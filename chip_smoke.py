#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout; it needs no build step (the kernels
build from ``src/repro_torch/kernels/csrc`` at first use) and one card.

1. Build the CUDA kernels with nvcc for sm_90a; print the card and the
   build time.
2. End-to-end parity at T = 512: the kernel plan twice (bitwise equal
   outputs: no non-deterministic scatter) and the plain plan (equal
   labels).
3. The main path: ``run_dsc`` on the repo's per-device configuration
   ``dsc_brest`` (4096 AIS-like vessels x 128 points, 8 lanes, TSA2,
   w = 20) with the kernel plan.  Launch counts are zeroed just before and
   read just after; every kernel of the path must have run.  Prints stage
   times (CUDA events), clustering rounds, peak device memory and the
   cluster / member / outlier counts.
4. Each kernel against its plain PyTorch version on the card, on the
   main path's full-size inputs: integer / boolean outputs equal, float
   outputs bitwise equal.  Times the kernel, the plain version and, where
   one PyTorch call computes the same function, that call.

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
    "jaccard_window": "src/repro/kernels/jaccard/jaccard.py:72",
    "round_scan": "src/repro/kernels/cluster/cluster.py:99",
    "claim_max": "src/repro/kernels/cluster/cluster.py:120",
}


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


def k1_window_pairs(batch, eps_t: float) -> int:
    """(ref point, candidate point) pairs of two different trajectories,
    both valid, with |dt| <= eps_t: the pairs whose distance the join
    needs.  A kernel that uses the time order of each trajectory's points
    evaluates only these; K1 as built evaluates all P * C * Mc."""
    t = batch.t.double()
    tv = torch.where(batch.valid, t, torch.inf)
    lo, hi = t - eps_t, t + eps_t
    flat = tv.flatten().sort().values
    every = (torch.searchsorted(flat, hi, right=True)
             - torch.searchsorted(flat, lo))
    rows = tv.sort(dim=1).values
    own = (torch.searchsorted(rows, hi, right=True)
           - torch.searchsorted(rows, lo))
    return int((every - own)[batch.valid].sum())


def brest_batch(n_vessels: int, dev):
    """The launcher's ``dsc_brest`` data and parameters
    (``repro.launch.run_dsc``: eps_sp = 0.15 * diameter, eps_t = mean
    sampling interval, delta_t = 0, w = 20, tau = 0.4, -1 sigma
    thresholds, 8 subtrajectories per trajectory, TSA2)."""
    from repro_torch.core.types import DSCParams
    from repro_torch.data.synthetic import ais_like, default_dsc_params_for
    batch, _ = ais_like(n_vessels=n_vessels, max_points=128, n_lanes=8,
                        seed=0, device=dev)
    diam, mean_dt = default_dsc_params_for(batch)
    params = DSCParams(eps_sp=0.15 * diam, eps_t=mean_dt, delta_t=0.0,
                       w=20, tau=0.4, alpha_sigma=-1.0, k_sigma=-1.0,
                       max_subtrajs_per_traj=8, segmentation="tsa2")
    return batch, params


def kernel_plan():
    from repro_torch.core.plan import EnginePlan
    return EnginePlan(mode="materialize", use_kernel=True,
                      seg_use_kernel=True, cluster_use_kernel=True,
                      sim_mode="dense", cluster_engine="rounds")


def check_output(out, batch, params):
    """The repo's own sanity conditions on a pipeline output."""
    T, M = batch.x.shape
    S = T * params.max_subtrajs_per_traj
    r = out.result
    check(out.vote.shape == (T, M) and torch.isfinite(out.vote).all(),
          "vote: shape or non-finite values")
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


def phase_main(dev, report):
    """The main path at full size; launch counts read around it."""
    from repro_torch import kernels
    from repro_torch.core.dsc import run_dsc
    batch, params = brest_batch(4096, dev)
    T, M = batch.x.shape
    log(f"main path: dsc_brest T={T} M={M} S={T * 8} "
        f"eps_sp={params.eps_sp:.6g} eps_t={params.eps_t:.6g}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_dsc(batch, params, plan=kernel_plan(), device=dev,
                  stage_times=times)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    check(launches["round_scan"] == out.rounds,
          "round_scan launches != clustering rounds")
    check_output(out, batch, params)
    r = out.result
    members = int((~r.is_rep & (r.member_of >= 0)).sum())
    log("stage ms (CUDA events): " + ", ".join(
        f"{k}={v:.3f}" for k, v in times.items()))
    log(f"main path wall s={wall:.3f} rounds={out.rounds} "
        f"peak_alloc_GB={peak / 1e9:.3f} clusters={int(r.is_rep.sum())} "
        f"members={members} outliers={int(r.is_outlier.sum())} "
        f"alpha={float(r.alpha_used):.6g} k={float(r.k_used):.6g}")
    log(f"launches: {launches}")
    report.update(stage_ms=times, wall_s=wall, rounds=out.rounds,
                  peak_alloc_bytes=peak, clusters=int(r.is_rep.sum()),
                  members=members, outliers=int(r.is_outlier.sum()),
                  launches=launches)
    return batch, params, out, launches


def phase_kernels(batch, params, out, launches):
    """Each kernel against its plain version on the main path's inputs."""
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
    rows = []
    T, M = batch.x.shape
    C, Mc = T, M
    P = T * M

    def row(name, err, ms, plain, bound, lib=None):
        b, by = bound
        rows.append({"name": name, "route": "cuda", "source": CSRC,
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": b, "bound_by": by, "library_ms": lib})
        log(f"  {name}: err={err} ms={ms:.4f} plain_ms={plain:.4f} "
            f"bound_ms={b:.4f} ({by}) library_ms={lib}")

    # ---- K1: the full [P, C] join, kernel and plain ----------------------
    ref_ops = (batch.x.reshape(-1), batch.y.reshape(-1), batch.t.reshape(-1),
               batch.traj_id[:, None].expand(T, M).reshape(-1).contiguous(),
               batch.valid.reshape(-1), batch.x, batch.y, batch.t,
               batch.traj_id, batch.valid, params.eps_sp, params.eps_t)
    kw, ki = stjoin_best_match(*ref_ops)
    ms = time_ms(lambda: stjoin_best_match(*ref_ops, out_w=kw, out_idx=ki),
                 reps=3)
    plain_out = []
    plain = time_ms(lambda: plain_out.append(stjoin_ref(*ref_ops)), reps=1,
                    warmup=0)
    pw, pi = plain_out.pop()
    check(torch.equal(ki, pi), "K1 best_idx differs from the plain version")
    err = float((kw - pw).abs().max())
    check(torch.equal(kw, pw), f"K1 best_w not bitwise (max err {err})")
    matched = int((ki >= 0).sum())
    needed = k1_window_pairs(batch, params.eps_t)
    nbytes = P * (4 * 4 + 1) + C * Mc * (3 * 4 + 1) + C * 4 + 8 * P * C
    row("stjoin_best_match", err, ms, plain,
        bound_ms(nbytes, K1_OPS_PER_PAIR * needed))
    sweep_ms = K1_OPS_PER_PAIR * P * C * Mc / F32_OPS_PER_S * 1e3
    log(f"  K1 pairs swept={P * C * Mc} needed (|dt| <= eps_t)={needed} "
        f"matched (p, c)={matched}; the full sweep's f32 floor "
        f"{sweep_ms:.4f} ms")
    del pw, pi

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
    row("jaccard_window", err, ms, plain, bound_ms(T * M * W * 4 + T * M * 5))
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
    row("round_scan", 0.0, ms, plain,
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
    row("claim_max", err, ms, plain,
        bound_ms(n_rep * S * 4.0 + S * 6 + S * 8))
    log(f"  K6 timed on the final {n_rep} representative rows")
    return rows


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
    batch, params, out, launches = phase_main(dev, report)
    rows = phase_kernels(batch, params, out, launches)
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
