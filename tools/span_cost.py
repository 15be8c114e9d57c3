#!/usr/bin/env python3
"""What ``run_dsc``'s spans cost on a CUDA card, at a benchmark cell's
first slice:

    python3 tools/span_cost.py [--cell brest.dense] [--seed N] [--jobs 60]
                               [--traced-jobs 20] [--json PATH]

Untraced: jobs with the spans off (``stage_times=None``) against jobs
with them timed (``stage_times={}``), alternating in ABBA order.  Traced,
under a recording ``torch.profiler`` (every job with ``stage_times={}``,
as a traced benchmark run): jobs with the spans' ranges against jobs with
them left out (the profiler's state hidden from ``run_dsc`` for that
call).  A job is ``run_dsc`` and its labels on the host, timed on the
host clock after the slice is on the card; the arms that time the spans
also give each span's mean ms.  Then each span name's events
on the device timeline, and how many of them the profiler marks as user
annotations (the benchmark's trace reader drops those from device work).
Prints one line an arm and a JSON line; ``--device cpu --n-trajs 96`` is
a small run without a card.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _job(prog, host, params, times, spans=None):
    """Seconds of one ``run_dsc`` and its labels on the host; ``times``
    (a dict, or None) is passed as ``stage_times`` and then appended to
    ``spans``."""
    batch = prog.Batch(*(a.to(prog.device, non_blocking=True)
                         for a in host))
    if prog.device.type == "cuda":
        torch.cuda.synchronize(prog.device)
    t0 = time.perf_counter()
    out = prog.run(batch, params, times)
    out.result.member_of.cpu()
    dt = time.perf_counter() - t0
    if spans is not None:
        spans.append(times)
    return dt


def _arms(n, a, b):
    """``n`` runs of each arm in ABBA order: ``{name: [seconds]}``."""
    res = {a[0]: [], b[0]: []}
    for i in range(n):
        for name, fn in ((a, b) if i % 2 == 0 else (b, a)):
            res[name].append(fn())
    return res


def _stats(xs):
    return {"n": len(xs), "mean_ms": 1e3 * statistics.fmean(xs),
            "median_ms": 1e3 * statistics.median(xs),
            "stdev_ms": 1e3 * statistics.stdev(xs) if len(xs) > 1 else 0.0}


def _diff(on, off):
    """Mean of the paired differences ``on - off`` (ms), its standard
    error, and the mean as a share of ``off``'s mean (%)."""
    d = [1e3 * (x - y) for x, y in zip(on, off)]
    se = statistics.stdev(d) / len(d) ** 0.5 if len(d) > 1 else 0.0
    return {"mean_ms": statistics.fmean(d), "se_ms": se,
            "pct": 100.0 * statistics.fmean(d) / (1e3 * statistics.fmean(off))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="brest.dense")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--jobs", type=int, default=60,
                    help="untraced jobs an arm")
    ap.add_argument("--traced-jobs", type=int, default=20,
                    help="traced jobs an arm")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-trajs", type=int, default=None,
                    help="cut the configuration's trajectories (CPU runs)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from dscbench import generator, harness

    dev = torch.device(args.device)
    cell = harness.load_cell(args.cell)
    if args.n_trajs:
        cell.config = dict(cell.config, n_trajs=args.n_trajs)
    prog = harness.Program(cell, dev)
    host, params = prog.host(generator.make_slice(cell.config, args.seed))
    for times in (None, {}):                     # warm-up
        _job(prog, host, params, times)

    per = {"timed": [], "ranges": [], "no_ranges": []}
    untraced = _arms(args.jobs,
                     ("off", lambda: _job(prog, host, params, None)),
                     ("timed", lambda: _job(prog, host, params, {},
                                            per["timed"])))
    spans = per["timed"][0]

    enabled = torch.autograd._profiler_enabled

    def hidden():
        torch.autograd._profiler_enabled = lambda: False
        try:
            return _job(prog, host, params, {}, per["no_ranges"])
        finally:
            torch.autograd._profiler_enabled = enabled

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        traced = _arms(args.traced_jobs,
                       ("ranges", lambda: _job(prog, host, params, {},
                                               per["ranges"])),
                       ("no_ranges", hidden))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    shadows = {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.name() in spans and e.device_type() == cuda:
            n, ann = shadows.get(e.name(), (0, 0))
            shadows[e.name()] = (n + 1, ann + bool(e.is_user_annotation()))

    res = {"cell": args.cell, "seed": args.seed, "device": str(dev),
           "card": (torch.cuda.get_device_name(dev)
                    if dev.type == "cuda" else "cpu"),
           "spans": list(spans),
           "untraced": {k: _stats(v) for k, v in untraced.items()},
           "timed_cost": _diff(untraced["timed"], untraced["off"]),
           "traced": {k: _stats(v) for k, v in traced.items()},
           "range_cost": _diff(traced["ranges"], traced["no_ranges"]),
           "span_ms": {arm: {k: statistics.fmean(t[k] for t in ts)
                             for k in spans} for arm, ts in per.items()},
           "device_shadows": {k: {"events": n, "user_annotation": a}
                              for k, (n, a) in shadows.items()}}
    for k in ("untraced", "traced"):
        for arm, st in res[k].items():
            print(f"{k} {arm}: " + ", ".join(f"{a}={b:.4f}"
                                             for a, b in st.items()))
    for k in ("timed_cost", "range_cost"):
        print(f"{k}: " + ", ".join(f"{a}={b:.5f}" for a, b in res[k].items()))
    for arm, ms in res["span_ms"].items():
        print(f"span ms, {arm}: " + ", ".join(f"{k}={v:.3f}"
                                              for k, v in ms.items()))
    print(f"device shadows: {res['device_shadows']}")
    print(json.dumps(res))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
