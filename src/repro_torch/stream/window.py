"""Bounded-lateness watermark + bounded staging queue (DESIGN.md §13.3).

The port's copy of ``repro.stream.window`` (plain Python and numpy:
the host side of the streaming service).

Event-time semantics follow the standard streaming contract:

* the **watermark** ``W = max admitted event time - allowed_lateness`` is
  monotone (it never moves backwards);
* a record with ``t >= W`` is *on time or tolerably late*: it is handed
  to the driver, which marks its object's row dirty and re-joins exactly
  the affected rows (the scoped re-join);
* a record with ``t < W`` is **beyond the allowed lateness**: it is
  counted in ``late_dropped`` and dropped — never silently folded into
  standing state;
* the active window retains event times in ``[W - horizon, +inf)``;
  points older than that are evicted by the driver at each advance.

The staging queue between ``stage()`` and ``drain()`` is bounded
(``queue_cap`` records).  On overflow the configured backpressure policy
applies: ``"shed_oldest"`` drops (and counts) the oldest staged records
to make room; ``"block"`` raises :class:`BackpressureOverflow` — a real
deployment would block the producer, a single-process service must
surface the pressure loudly instead of OOMing.  A watermark that fails
to advance for ``stall_advances`` consecutive drains while records keep
arriving raises :class:`WatermarkStall`.  Both map to launcher exit
code 8.
"""
from __future__ import annotations

import numpy as np

from repro_torch.stream.ingest import Records, concat_records, take_records


class BackpressureOverflow(RuntimeError):
    """Staging queue exceeded ``queue_cap`` under the ``block`` policy
    (exit code 8)."""


class WatermarkStall(RuntimeError):
    """Watermark failed to advance for ``stall_advances`` consecutive
    drains while records kept arriving (exit code 8)."""


class WindowManager:
    """Watermark bookkeeping + the bounded staging queue."""

    def __init__(self, allowed_lateness: float, horizon: float,
                 queue_cap: int = 4096, policy: str = "shed_oldest",
                 stall_advances: int = 0):
        if policy not in ("shed_oldest", "block"):
            raise ValueError(f"policy={policy!r}: expected 'shed_oldest' "
                             "or 'block'")
        if allowed_lateness < 0 or horizon <= 0:
            raise ValueError("allowed_lateness must be >= 0 and "
                             "horizon > 0")
        if queue_cap < 1:
            raise ValueError("queue_cap must be >= 1")
        self.allowed_lateness = float(allowed_lateness)
        self.horizon = float(horizon)
        self.queue_cap = int(queue_cap)
        self.policy = policy
        self.stall_advances = int(stall_advances)
        self.watermark = -np.inf      # no record admitted yet
        self.late_dropped = 0
        self.shed = 0
        self.staged_total = 0
        self._queue: list[Records] = []
        self._queued_n = 0
        self._stalled = 0             # consecutive non-advancing drains

    # ------------------------------------------------------------------ api
    def queued(self) -> int:
        return self._queued_n

    def stage(self, recs: Records) -> int:
        """Enqueue a validated submission; returns records shed to make
        room (0 unless the shed_oldest policy fired)."""
        if recs.n == 0:
            return 0
        if recs.n > self.queue_cap and self.policy == "block":
            raise BackpressureOverflow(
                f"submission of {recs.n} records exceeds queue_cap="
                f"{self.queue_cap}")
        self.staged_total += recs.n
        self._queue.append(recs)
        self._queued_n += recs.n
        shed_now = 0
        while self._queued_n > self.queue_cap:
            if self.policy == "block":
                # undo the enqueue so the caller can retry after draining
                self._queue.pop()
                self._queued_n -= recs.n
                self.staged_total -= recs.n
                raise BackpressureOverflow(
                    f"staging queue full ({self._queued_n} + {recs.n} > "
                    f"queue_cap={self.queue_cap})")
            oldest = self._queue[0]
            need = self._queued_n - self.queue_cap
            drop = min(need, oldest.n)
            if drop == oldest.n:
                self._queue.pop(0)
            else:
                self._queue[0] = take_records(
                    oldest, np.arange(drop, oldest.n))
            self._queued_n -= drop
            self.shed += drop
            shed_now += drop
        return shed_now

    def drain(self) -> tuple[Records, int]:
        """Pop every staged record; split into (admitted, late_dropped).

        Admitted records advance the watermark; records already beyond
        it are counted and dropped.  The stall counter ticks when
        records arrived but the watermark did not move.
        """
        recs = concat_records(self._queue)
        self._queue = []
        self._queued_n = 0
        if recs.n == 0:
            return recs, 0
        w0 = self.watermark
        t = recs.t.astype(np.float64)
        # watermark first: lateness is judged against the watermark the
        # *batch* establishes, matching an upstream shuffle-free stream
        # where the max-t record may arrive first within the drain
        new_w = max(self.watermark,
                    float(np.max(t)) - self.allowed_lateness)
        late = t < new_w
        n_late = int(np.sum(late))
        self.late_dropped += n_late
        self.watermark = new_w
        if self.watermark <= w0:
            self._stalled += 1
            if self.stall_advances and self._stalled >= self.stall_advances:
                raise WatermarkStall(
                    f"watermark stalled at {self.watermark} for "
                    f"{self._stalled} consecutive drains with records "
                    "still arriving")
        else:
            self._stalled = 0
        return take_records(recs, np.nonzero(~late)[0]), n_late

    def evict_before(self) -> float:
        """Lower edge of the active window (event time)."""
        return self.watermark - self.horizon

    # --------------------------------------------------------- serialization
    def state_arrays(self) -> dict:
        """Snapshot state.  The staging queue is intentionally *not*
        serialized: the driver snapshots at advance boundaries, where the
        queue has just been drained, and the record-source cursor replays
        anything submitted after the snapshot (DESIGN.md §13.5)."""
        return {
            "scalars_f": np.asarray([self.watermark], np.float64),
            "scalars_i": np.asarray(
                [self.late_dropped, self.shed, self.staged_total,
                 self._stalled], np.int64),
        }

    def load_state_arrays(self, st: dict):
        self.watermark = float(st["scalars_f"][0])
        self.late_dropped, self.shed, self.staged_total, self._stalled = (
            int(v) for v in st["scalars_i"])
