"""The benchmark's harness: a cell's files by name, the program driven
job by job through a measured window, the check, and the result line.

Everything that belongs to one cell, configuration, traffic mix, plan or
metric is a file of its own, found by name:

* ``cells/<cell>.json``: the configuration and traffic it pairs, the chips
  it needs, its end-to-end metrics and the limits of its checks;
* ``configs/<config>.json``: the deployment (data generator, sizes, the
  parameter rule);
* ``workloads/<traffic>.json``: the traffic mix (the engine plan, the loop,
  the slices rotated, warm-up, how many jobs the trace covers; optionally
  ``slice_seeds``, a fixed set of slices that the run's seed does not
  change: the seed's own slice is then run once after the window and
  checked);
* ``plans/<plan>.json``: an ``EnginePlan`` of the program;
* ``metrics/<metric>.py``: a reader with ``KIND``, ``UNIT`` and
  ``read(run)``, which returns ``None`` where it finds nothing to read.

The system under test is ``repro_torch`` from the checkout's ``src/``:
a job copies one slice to the device, runs ``run_dsc`` under the cell's
plan and brings the labels back to the host; jobs run in a closed loop
with one client.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path

import torch

from dscbench import generator, trace as trace_mod
from dscbench.reference import compare, pipeline

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _load(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict       # cells/<name>.json
    config: dict     # configs/<config>.json
    traffic: dict    # workloads/<traffic>.json
    plan: dict       # plans/<plan>.json

    @property
    def chips(self) -> int:
        return int(self.spec.get("chips", 1))


def check_traffic(traffic: dict, name: str) -> dict:
    """A traffic mix with its optional ``slice_seeds`` checked: one int a
    slice."""
    n = int(traffic["slices"])
    seeds = traffic.get("slice_seeds")
    if seeds is not None and (
            not isinstance(seeds, list) or len(seeds) != n
            or not all(type(s) is int for s in seeds)):
        raise ValueError(f"traffic {name!r}: slice_seeds must be a list of "
                         f"slices = {n} ints, got {seeds!r}")
    return traffic


def slice_seeds(traffic: dict, seed: int) -> list[int]:
    """The seed of each slice: the traffic's ``slice_seeds`` where it has
    them (the run's seed then changes no data), else ``seed + i``."""
    fixed = traffic.get("slice_seeds")
    if fixed is not None:
        return list(fixed)
    return [seed + i for i in range(int(traffic["slices"]))]


def load_cell(name: str, base: Path = HERE) -> Cell:
    """A cell and every file it names (under ``base``)."""
    spec = _load("cells", name, base)
    traffic = check_traffic(_load("workloads", spec["traffic"], base),
                            spec["traffic"])
    return Cell(name=name, spec=spec,
                config=_load("configs", spec["config"], base),
                traffic=traffic, plan=_load("plans", traffic["plan"], base))


def cell_names(base: Path = HERE) -> list[str]:
    return sorted(p.stem for p in (base / "cells").glob("*.json"))


def metric_readers(base: Path = HERE) -> dict:
    """Every reader under ``metrics/``, by metric name."""
    out = {}
    for path in sorted((base / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(
            "dscbench_metric_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Job:
    slice: int
    start: float              # host clock, s
    end: float
    due: float                # when it was submitted (closed loop: start)
    transfer_ms: float | None = None
    stage_ms: dict | None = None
    rounds: int | None = None

    @property
    def wall_ms(self) -> float:
        """From submission to the labels on the host (an open loop counts
        the wait in the queue)."""
        return (self.end - self.due) * 1e3


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    jobs: list            # every job of the window
    window_s: float
    setup_s: float
    peak_bytes: int
    traced: list          # the jobs inside the traced window
    trace: object | None  # trace.Summary
    work: dict            # slice -> (n_pairs, n_best), slices with jobs
    slices: list          # generator.Slice
    power_limit_w: float | None


class Arrivals:
    """When jobs are submitted.  ``loop: "closed"`` (one client): the next
    job as soon as the last one's labels are on the host.  ``loop:
    "open"``: one every ``1 / rate_per_s`` seconds, whatever the queue; a
    job waits for the one before it."""

    def __init__(self, traffic: dict):
        loop = traffic.get("loop", "closed")
        if loop not in ("closed", "open"):
            raise ValueError(f"unknown loop {loop!r}")
        self.gap = 1.0 / float(traffic["rate_per_s"]) if loop == "open" \
            else None

    def due(self, w0: float, n: int) -> float | None:
        """The n-th job's submission time (None in a closed loop)."""
        return None if self.gap is None else w0 + n * self.gap

    def done(self, w0: float, n: int, now: float, deadline: float) -> bool:
        """Whether the window is over after ``n`` jobs: closed, once the
        time has run out; open, once the next job is due after it (every
        job due inside the window is served, however late)."""
        if self.gap is None:
            return now >= deadline
        return self.due(w0, n) >= deadline


class Program:
    """The system under test: ``repro_torch.core.dsc.run_dsc`` from the
    checkout's ``src/`` under the cell's plan."""

    def __init__(self, cell: Cell, device: torch.device):
        src = ROOT / "src"
        if str(src) not in sys.path:
            sys.path.insert(0, str(src))
        import repro_torch
        from repro_torch.core.dsc import run_dsc
        from repro_torch.core.plan import EnginePlan
        from repro_torch.core.types import DSCParams, TrajectoryBatch
        if not Path(repro_torch.__file__).resolve().is_relative_to(src):
            raise RuntimeError(f"repro_torch loaded from {repro_torch.__file__},"
                               f" not from {src}")
        self.run_dsc = run_dsc
        self.Batch = TrajectoryBatch
        self.Params = DSCParams
        self.plan = EnginePlan.from_dict(cell.plan)
        self.device = device

    def host(self, sl: generator.Slice):
        """The slice as host tensors (pinned for the card) and params."""
        arrs = tensors(sl, torch.device("cpu"))
        if self.device.type == "cuda":
            arrs = [a.pin_memory() for a in arrs]
        return arrs, self.Params(**sl.params)

    def run(self, batch, params, stage_times):
        """``run_dsc`` itself: the seam that the fault tests break."""
        return self.run_dsc(batch, params, plan=self.plan,
                            device=self.device, stage_times=stage_times)

    def job(self, host, params, timed: bool):
        """One job: the slice to the device, ``run_dsc``, the labels to the
        host.  Returns ``(labels, out, extra)``; ``timed`` adds the copies'
        device time and the stage times."""
        cuda = self.device.type == "cuda"
        ev = ([torch.cuda.Event(enable_timing=True) for _ in range(4)]
              if timed and cuda else None)
        rf = torch.autograd.profiler.record_function if timed else None
        with rf("job.h2d") if rf else nullcontext():
            if ev:
                ev[0].record()
            batch = self.Batch(*(a.to(self.device, non_blocking=True)
                                 for a in host))
            if ev:
                ev[1].record()
        stages = {} if timed else None
        with rf("job.run_dsc") if rf else nullcontext():
            out = self.run(batch, params, stages)
        with rf("job.labels") if rf else nullcontext():
            if ev:
                ev[2].record()
            res = out.result
            labels = (res.member_of.cpu().numpy(), res.is_rep.cpu().numpy(),
                      res.is_outlier.cpu().numpy())
            if ev:
                ev[3].record()
                ev[3].synchronize()
        extra = dict(rounds=out.rounds)
        if timed:
            extra["stage_ms"] = stages
            if ev:
                extra["transfer_ms"] = (ev[0].elapsed_time(ev[1])
                                        + ev[2].elapsed_time(ev[3]))
        return labels, out, extra


def tensors(sl: generator.Slice, device: torch.device) -> list:
    """A slice's ``(x, y, t, valid, traj_id)`` as tensors on ``device``."""
    return [torch.from_numpy(a).to(device)
            for a in (sl.x, sl.y, sl.t, sl.valid, sl.traj_id)]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit_w() -> float | None:
    """The card's power limit from ``nvidia-smi`` (None where it cannot be
    read)."""
    import subprocess
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=20)
        return float(p.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _worse(a: dict, b: dict) -> dict:
    """Each reading's worse of two; NaN where either is NaN or lacks it."""
    out = {}
    for k in a.keys() | b.keys():
        x, y = a.get(k, math.nan), b.get(k, math.nan)
        out[k] = math.nan if math.isnan(x) or math.isnan(y) else max(x, y)
    return out


def check_seed_slice(cell: Cell, prog: Program, seed: int,
                     device: torch.device) -> tuple[dict, int | None]:
    """Under fixed slices, the run's own slice (``make_slice(config,
    seed)``): one job after the window through the timed path, untimed,
    its outputs layer by layer and its labels against its reference.
    Returns ``(readings, the reference's final K)``; a job that fails
    reads NaN."""
    sim_mode = cell.plan.get("sim_mode", "dense")
    k0 = int(cell.plan.get("sim_topk") or 32)
    sl = generator.make_slice(cell.config, seed)
    try:
        labels, out, _ = prog.job(*prog.host(sl), timed=False)
    except Exception:
        traceback.print_exc()
        return {"labels": math.nan}, None
    ref = pipeline.run(tensors(sl, device), sl.params)
    values = compare.readings(out, ref, sim_mode, k0)
    del out
    values["labels"] = float(compare.label_gaps(labels, ref))
    return values, (ref.topk_k(k0) if sim_mode != "dense" else None)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, program: Program | None = None
             ) -> tuple[dict, list[str]]:
    """One run of a cell: ``(result, check_lines)``."""
    traffic = cell.traffic
    n_slices = int(traffic["slices"])
    seeds = slice_seeds(traffic, seed)
    marks = [time.perf_counter()]
    slices = [generator.make_slice(cell.config, s) for s in seeds]
    marks.append(time.perf_counter())
    prog = program or Program(cell, device)
    hosts = [prog.host(sl) for sl in slices]
    marks.append(time.perf_counter())
    for _ in range(int(traffic["warmup_jobs_per_slice"])):
        for i in range(n_slices):
            _, out, _ = prog.job(*hosts[i], timed=trace)
            del out
    _sync(device)
    marks.append(time.perf_counter())
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    jobs, labels_by_slice = [], [[] for _ in slices]
    failed, last_out = 0, None
    trace_jobs = traffic.get("trace_jobs")
    prof = trace_mod.start(device) if trace else None
    profiled = None
    arrivals = Arrivals(traffic)
    w0 = time.perf_counter()
    deadline = w0 + seconds
    while True:
        i = len(jobs) % n_slices
        due = arrivals.due(w0, len(jobs))
        if due is not None:
            time.sleep(max(0.0, due - time.perf_counter()))
        s = time.perf_counter()
        try:
            labels, out, extra = prog.job(*hosts[i], timed=trace)
        except Exception:       # a job that fails is an answer never given
            traceback.print_exc()
            failed += 1
            break
        e = time.perf_counter()
        jobs.append(Job(slice=i, start=s, end=e,
                        due=s if due is None else due, **extra))
        labels_by_slice[i].append(labels)
        if prof is not None and trace_jobs and len(jobs) == trace_jobs:
            profiled, prof = trace_mod.stop(prof, device), None
        if arrivals.done(w0, len(jobs), e, deadline):
            last_out = out
            break
        del out
    window_end = jobs[-1].end if jobs else time.perf_counter()
    if prof is not None:
        profiled = trace_mod.stop(prof, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    window_s = window_end - w0
    setup_s = w0 - t0
    t1 = time.perf_counter()
    summary = trace_mod.summarize(profiled) if profiled is not None else None
    trace_s = time.perf_counter() - t1
    n_traced = min(len(jobs), trace_jobs or len(jobs))
    traced = jobs[:n_traced] if trace else []

    # the check: every slice that a job of the window ran, against its
    # reference; the last job's outputs layer by layer, and every job's
    # labels.  The last job's slice goes first, so that its outputs are
    # freed before the other references run.  Under fixed slices the
    # seed's own slice is checked too, so that each seed checks new data.
    values, work, lists_k, check_k = {}, {}, {}, None
    sim_mode = cell.plan.get("sim_mode", "dense")
    k0 = int(cell.plan.get("sim_topk") or 32)
    t1 = time.perf_counter()
    if last_out is not None:
        ck = jobs[-1].slice
        gaps = []
        for i in [ck] + [j for j in range(n_slices) if j != ck]:
            if not labels_by_slice[i]:
                continue
            ref = pipeline.run(tensors(slices[i], device), slices[i].params)
            if i == ck:
                values = compare.readings(last_out, ref, sim_mode, k0)
                last_out = None
            gaps += [compare.label_gaps(lab, ref)
                     for lab in labels_by_slice[i]]
            work[i] = (ref.n_pairs, ref.n_best)
            if sim_mode != "dense":
                lists_k[i] = ref.topk_k(k0)
            del ref
        values["labels"] = float(max(gaps))
        if "slice_seeds" in traffic:
            seen, check_k = check_seed_slice(cell, prog, seed, device)
            values = _worse(values, seen)
    correct, checks = compare.verdict(values, cell.spec["checks"])
    correct = correct and failed == 0
    ref_s = time.perf_counter() - t1

    run = Run(cell=cell, jobs=jobs, window_s=window_s, setup_s=setup_s,
              peak_bytes=peak, traced=traced, trace=summary, work=work,
              slices=slices,
              power_limit_w=power_limit_w() if device.type == "cuda" else None)
    metrics = {}
    readers = metric_readers()
    wanted = (cell.spec["end_to_end"] if not trace else
              [n for n, m in readers.items() if m.KIND == "per_layer"])
    for name in wanted:
        v = readers[name].read(run) if jobs else None
        if v is not None:
            metrics[name] = {"value": v, "unit": readers[name].UNIT}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if run.power_limit_w is not None:
        dev["power_limit_w"] = run.power_limit_w
    result = {"correct": bool(correct), "attempted": len(jobs) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    lines = [f"dscbench: {cell.name} seed {seed}: setup {setup_s:.3f} s "
             f"(imports {marks[0] - t0:.3f}, slices {marks[1] - marks[0]:.3f},"
             f" program and pinned slices {marks[2] - marks[1]:.3f}, warm-up "
             f"{marks[3] - marks[2]:.3f}), "
             f"window {window_s:.3f} s, {len(jobs)} jobs, trace reading "
             f"{trace_s:.3f} s, reference {ref_s:.3f} s ({len(work)} slices,"
             f" layer by layer on slice {jobs[-1].slice if jobs else None})"]
    for i, sd in enumerate(seeds):
        walls = [j.wall_ms for j in jobs if j.slice == i]
        lines.append(
            f"slice {i}: seed {sd}, {len(walls)} jobs, mean wall "
            f"{sum(walls) / len(walls) if walls else float('nan'):.3f} ms"
            + (f", final K {lists_k[i]}" if i in lists_k else ""))
    if "slice_seeds" in traffic and jobs:
        lines.append(f"the seed's slice: seed {seed}, checked after the "
                     "window" + (f", final K {check_k}" if check_k else ""))
    lines += [f"check {n}: {c['value']!r} limit {c['limit']!r}"
              for n, c in checks.items()]
    return result, lines

