"""Straggler detection — the paper's windowed change detector, repurposed.

The port's copy of ``repro.distributed.straggler`` (plain Python and numpy).

TSA1 cuts a trajectory when the mean of two adjacent sliding windows over its
voting signal diverges; a straggling host is the same signal shape: its
step-time series departs from the fleet's.  ``StragglerMonitor`` keeps a
per-host ring buffer of step durations and flags hosts whose recent window
mean exceeds the fleet median by ``threshold`` sigmas (or ratio).

Hooks: ``on_straggler`` receives (host_id, ratio); production deployments
wire this to the elastic controller (checkpoint-evict-restart, or re-split
the equi-depth partitions the way the paper rebalances time bins; the
resilient runner ``repro_torch.run.resilient`` records the flags in its
JSONL telemetry).  ``suggest_rebalance_edges`` is the re-split the
multi-device runner suggests or applies.
"""
from __future__ import annotations

import collections
import warnings
from typing import Callable, Optional

import numpy as np


class StragglerMonitor:
    def __init__(self, n_hosts: int, window: int = 16,
                 ratio_threshold: float = 1.5,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.n_hosts = n_hosts
        self.window = window
        self.ratio_threshold = ratio_threshold
        self.on_straggler = on_straggler
        self.history = [collections.deque(maxlen=2 * window)
                        for _ in range(n_hosts)]
        self.flagged: dict[int, float] = {}

    def record(self, host: int, step_seconds: float):
        self.history[host].append(step_seconds)

    def record_all(self, step_seconds):
        for h, s in enumerate(step_seconds):
            self.record(h, float(s))

    def reset(self, host: int):
        """Drop a host's history (and any current flag) — an evicted or
        rebalanced rank restarts with a clean series, so its pre-eviction
        step times can't keep re-flagging it."""
        self.history[host].clear()
        self.flagged.pop(host, None)

    def check(self) -> dict[int, float]:
        """Returns {host: ratio} for currently-flagged stragglers."""
        means = []
        for h in range(self.n_hosts):
            buf = list(self.history[h])[-self.window:]
            means.append(np.mean(buf) if buf else np.nan)
        means = np.asarray(means)
        with warnings.catch_warnings():
            # hosts with no samples contribute NaN; an all-NaN fleet is a
            # legal "no data yet" state, not a RuntimeWarning
            warnings.simplefilter("ignore", RuntimeWarning)
            fleet = np.nanmedian(means)
        self.flagged = {}
        if not np.isfinite(fleet) or fleet <= 0:
            return self.flagged
        for h in range(self.n_hosts):
            if np.isfinite(means[h]):
                ratio = float(means[h] / fleet)
                if ratio >= self.ratio_threshold:
                    self.flagged[h] = ratio
                    if self.on_straggler:
                        self.on_straggler(h, ratio)
        return self.flagged

    def change_detected(self, host: int, tau: float = 0.5) -> bool:
        """TSA1-style: |mean(W1) - mean(W2)| / mean(W1) > tau on the host's
        own series — catches a host that *becomes* slow (vs. always-slow)."""
        buf = list(self.history[host])
        if len(buf) < 2 * self.window:
            return False
        w1 = np.mean(buf[-2 * self.window:-self.window])
        w2 = np.mean(buf[-self.window:])
        return abs(w2 - w1) / max(w1, 1e-9) > tau


def suggest_rebalance_edges(times, part_of: np.ndarray,
                            flagged: dict[int, float],
                            P: int) -> np.ndarray:
    """Slowdown-weighted equi-depth re-split of the temporal bins.

    ``times``/``part_of`` give each valid point's timestamp and current
    partition; a point in a flagged partition is weighted by that
    partition's slowdown ratio, so the weighted equi-depth quantiles
    narrow the slow partitions' time ranges proportionally — the paper's
    time-bin rebalancing driven by the monitor's flags instead of the
    input histogram.  Returns ``P + 1`` edges shaped like
    ``repro_torch.core.partitioning.equi_depth_edges`` (±inf outer edges).
    """
    times = np.asarray(times, np.float64).ravel()
    part_of = np.asarray(part_of).ravel()
    w = np.ones_like(times)
    for p, ratio in flagged.items():
        w[part_of == p] = max(float(ratio), 1.0)
    order = np.argsort(times, kind="stable")
    times, w = times[order], w[order]
    cum = np.cumsum(w)
    targets = cum[-1] * np.arange(1, P) / P
    inner = times[np.searchsorted(cum, targets, side="left")]
    inner = np.maximum.accumulate(inner)
    return np.concatenate(([-np.inf], inner, [np.inf]))
