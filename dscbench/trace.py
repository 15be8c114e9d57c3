"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
traced jobs, reduced to the device's busy time, each kernel's intervals,
and where the device sat idle.

Busy time is the union of the device operations' intervals (kernels,
copies, sets), so overlapping work counts once; the traced window runs
from the first traced job's start (its ``job.h2d`` range) to the last
one's end (its ``job.labels`` range).  An idle gap is named after the
innermost host range or operator that was open at its middle.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

import torch

def start(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop(prof, device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    return prof


def short(name: str) -> str:
    """A kernel's name without its return type, its argument list and
    anonymous namespaces, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name.strip()[:120]


def union(spans) -> list[tuple[float, float]]:
    """Merged intervals of ``(start, end)`` pairs."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(spans, points) -> list[str]:
    """For each point, the name of the latest-starting ``(start, end,
    name)`` span that covers it ("host" where none does): a sweep over the
    points in order with a heap of the open spans."""
    spans = sorted(spans)
    order = sorted(range(len(points)), key=points.__getitem__)
    out = ["host"] * len(points)
    heap, i = [], 0
    for k in order:
        p = points[k]
        while i < len(spans) and spans[i][0] <= p:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        if heap:
            out[k] = heap[0][2]
    return out


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: dict     # short name -> [(start_s, end_s)] in start order
    gaps: list        # (seconds, host name) of the window's idle gaps

    def kernel_seconds(self, name: str) -> list[float]:
        return [e - s for s, e in self.kernels.get(name, [])]

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, sum(e - s for s, e in v))
                      for n, v in self.kernels.items()),
                     key=lambda kv: -kv[1])[:top]
        by = defaultdict(float)
        for sec, name in self.gaps:
            by[name] += sec
        gaps = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _events(prof):
    """``(name, on_device, start_s, end_s, host_range)`` of every event,
    from the profiler's raw results (building ``prof.events()``'s tree
    takes minutes for a top-K job's hundreds of thousands of launches)."""
    cuda = torch.autograd.DeviceType.CUDA
    kr = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if kr is None:
        for e in prof.events():
            yield (e.name, e.device_type == cuda, e.time_range.start / 1e6,
                   e.time_range.end / 1e6,
                   bool(getattr(e, "is_user_annotation", False)))
        return
    for e in kr.events():
        s = e.start_ns()
        yield (e.name(), e.device_type() == cuda, s / 1e9,
               (s + e.duration_ns()) / 1e9, bool(e.is_user_annotation()))


def summarize(prof) -> Summary | None:
    """The profile reduced (times in seconds on the profiler's clock);
    ``None`` when no traced job is in it."""
    dev, cpu = [], []
    h2d, labels = [], []
    for name, on_device, s, t, annotation in _events(prof):
        if on_device:
            # the host ranges' shadows on the device timeline are no work
            if not annotation and not name.startswith("job."):
                dev.append((short(name), s, t))
        else:
            cpu.append((s, t, name))
            if name == "job.h2d":
                h2d.append(s)
            elif name == "job.labels":
                labels.append(t)
    if not h2d or not labels:
        return None
    w0, w1 = min(h2d), max(labels)
    kernels = defaultdict(list)
    for n, s, t in sorted(dev, key=lambda d: d[1]):
        kernels[n].append((s, t))
    spans = [(max(s, w0), min(t, w1)) for _, s, t in dev if t > w0 and s < w1]
    busy = union(spans)
    busy_s = sum(t - s for s, t in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
             for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    holes.sort(reverse=True)
    gaps = [(sec, name) for (sec, _, _), name in
            zip(holes, _innermost(cpu, [0.5 * (a + b) for _, a, b in holes]))]
    return Summary(window_s=w1 - w0, busy_s=busy_s, kernels=dict(kernels),
                   gaps=gaps)
