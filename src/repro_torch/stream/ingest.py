"""Streaming ingest/validation: admit clean point records, quarantine dirt.

The port's copy of ``repro.stream.ingest`` (plain Python and numpy:
the host side of the streaming service).

Live AIS/taxi feeds are full of records the batch pipeline never sees:
NaN positions, duplicated fixes, sensor clocks jumping backwards, GPS
teleports.  The :class:`Ingestor` is the one gate every record passes
before it can touch window state, with three dispositions
(DESIGN.md §13.2):

* ``on_dirty="repair"`` — fix what is mechanically fixable (out-of-order
  timestamps inside a submission are stable-sorted back into order and
  counted as ``repaired_order``), quarantine the rest;
* ``on_dirty="drop"``   — quarantine every dirty record (non-monotone
  timestamps included);
* ``on_dirty="fail"``   — raise :class:`PoisonRecord` on the first dirty
  record (the launcher maps this to exit code 7).

A quarantined record is never silently discarded: every rejection
increments a per-reason counter and lands in a *bounded* quarantine log
(newest-kept ring), so the accounting invariant

    submitted == admitted + quarantined (+ the window layer's
                 late_dropped / shed)

holds exactly — the chaos suite asserts it under fault injection.

Everything here is plain numpy and fully deterministic; the whole
ingest state (counters, per-object last fix, the log ring) serializes to
flat arrays so it rides inside the driver's snapshot.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

# quarantine reasons, in counter order (the snapshot serializes counters
# as one int64 vector aligned with this tuple — order is part of the
# snapshot schema, append only)
QUARANTINE_REASONS = ("nonfinite", "duplicate", "non_monotone", "teleport")

# log ring reason codes == index into QUARANTINE_REASONS
_REASON_CODE = {r: i for i, r in enumerate(QUARANTINE_REASONS)}


class PoisonRecord(RuntimeError):
    """A dirty record arrived under ``on_dirty="fail"`` (exit code 7)."""


class Records(NamedTuple):
    """One submission batch of raw point records (parallel arrays)."""

    obj: np.ndarray   # [N] int32 object ids
    x: np.ndarray     # [N] float32
    y: np.ndarray     # [N] float32
    t: np.ndarray     # [N] float32 event time (seconds)

    @property
    def n(self) -> int:
        return int(self.obj.shape[0])

    @staticmethod
    def build(obj, x, y, t) -> "Records":
        return Records(np.asarray(obj, np.int32),
                       np.asarray(x, np.float32),
                       np.asarray(y, np.float32),
                       np.asarray(t, np.float32))


def take_records(recs: Records, idx) -> Records:
    return Records(recs.obj[idx], recs.x[idx], recs.y[idx], recs.t[idx])


def concat_records(parts: list[Records]) -> Records:
    if not parts:
        return Records.build([], [], [], [])
    return Records(*(np.concatenate([getattr(p, f) for p in parts])
                     for f in Records._fields))


class Ingestor:
    """Stateful validation gate in front of the window store.

    ``known_t_fn(obj) -> np.ndarray`` (optional) exposes the window
    store's admitted event times for an object, so duplicates against
    *already-admitted* fixes are caught, not just duplicates within one
    submission.  ``max_speed`` (units/s) arms the GPS-teleport check
    against the object's last admitted fix; ``None`` disables it.
    """

    def __init__(self, on_dirty: str = "repair",
                 max_speed: Optional[float] = None,
                 quarantine_cap: int = 256,
                 known_t_fn: Optional[Callable] = None):
        if on_dirty not in ("repair", "drop", "fail"):
            raise ValueError(f"on_dirty={on_dirty!r}: expected "
                             "'repair', 'drop', or 'fail'")
        if quarantine_cap < 1:
            raise ValueError("quarantine_cap must be >= 1")
        self.on_dirty = on_dirty
        self.max_speed = max_speed
        self.quarantine_cap = int(quarantine_cap)
        self.known_t_fn = known_t_fn
        self.counters = {r: 0 for r in QUARANTINE_REASONS}
        self.repaired_order = 0
        self.submitted = 0
        self.admitted = 0
        # per-object last admitted fix (teleport baseline)
        self._last: dict[int, tuple[float, float, float]] = {}
        # bounded quarantine log: newest-kept ring of
        # (seq, obj, t, reason_code) rows
        self._log: list[tuple[int, int, float, int]] = []
        self._seq = 0
        # per-object event times admitted from the submission being
        # processed (duplicate / non-monotone checks within one batch)
        self._batch_seen: dict[int, set] = {}

    # ------------------------------------------------------------- internals
    def _quarantine(self, obj: int, t: float, reason: str):
        if self.on_dirty == "fail":
            raise PoisonRecord(
                f"poison record obj={obj} t={t}: {reason} "
                f"(on_dirty='fail')")
        self.counters[reason] += 1
        self._log.append((self._seq, int(obj), float(t),
                          _REASON_CODE[reason]))
        if len(self._log) > self.quarantine_cap:
            del self._log[0]

    def _is_teleport(self, obj: int, x: float, y: float, t: float) -> bool:
        if self.max_speed is None:
            return False
        last = self._last.get(int(obj))
        if last is None:
            return False
        lx, ly, lt = last
        dt = abs(t - lt)
        dist = float(np.hypot(x - lx, y - ly))
        # a zero-dt different-position fix is an infinite-speed jump
        return dist > self.max_speed * max(dt, 1e-9)

    # ------------------------------------------------------------------ api
    def process(self, recs: Records) -> Records:
        """Validate one submission; returns the admitted records (in
        admission order) and books everything else into quarantine."""
        n = recs.n
        self.submitted += n
        if n == 0:
            return recs
        obj = recs.obj.astype(np.int64)
        x = recs.x.astype(np.float64)
        y = recs.y.astype(np.float64)
        t = recs.t.astype(np.float64)

        order = np.arange(n)
        if self.on_dirty == "repair":
            # repair in-batch timestamp swaps: stable sort by (obj, t)
            srt = np.lexsort((t, obj))
            if not np.array_equal(srt, order):
                # count records whose relative position moved
                self.repaired_order += int(np.sum(srt != order))
            order = srt

        keep: list[int] = []
        for i in order:
            oi, xi, yi, ti = int(obj[i]), x[i], y[i], t[i]
            self._seq += 1
            if not (np.isfinite(xi) and np.isfinite(yi)
                    and np.isfinite(ti)):
                self._quarantine(oi, ti if np.isfinite(ti) else 0.0,
                                 "nonfinite")
                continue
            seen = self._batch_seen.get(oi)
            # duplicate: same (obj, t) as an already-admitted fix — in
            # this submission or in the window store
            dup = False
            if seen is not None and ti in seen:
                dup = True
            elif self.known_t_fn is not None:
                known = np.asarray(self.known_t_fn(oi), np.float64)
                dup = bool(known.size) and bool(
                    np.any(known == np.float64(np.float32(ti))))
            last = self._last.get(oi)
            if not dup and last is not None and ti == last[2]:
                dup = True
            if dup:
                self._quarantine(oi, ti, "duplicate")
                continue
            # non-monotone: the fix steps backwards past a fix already
            # admitted from this same submission (a late fix relative to
            # the *store* is the watermark's business, not quarantine's)
            if seen is not None and seen and ti < max(seen):
                self._quarantine(oi, ti, "non_monotone")
                continue
            if self._is_teleport(oi, xi, yi, ti):
                self._quarantine(oi, ti, "teleport")
                continue
            keep.append(int(i))
            if seen is None:
                self._batch_seen[oi] = {ti}
            else:
                seen.add(ti)
            if last is None or ti >= last[2]:
                self._last[oi] = (xi, yi, ti)
        out = take_records(recs, np.asarray(keep, np.int64))
        self.admitted += out.n
        self._batch_seen = {}
        return out

    def quarantined_total(self) -> int:
        return sum(self.counters.values())

    def quarantine_log(self) -> list[dict]:
        """Newest-kept log entries as dicts (bounded by quarantine_cap)."""
        return [{"seq": s, "obj": o, "t": t,
                 "reason": QUARANTINE_REASONS[c]}
                for s, o, t, c in self._log]

    # --------------------------------------------------------- serialization
    def state_arrays(self) -> dict:
        """Flat numpy state (rides inside the driver snapshot)."""
        objs = sorted(self._last)
        log = self._log or []
        return {
            "counters": np.asarray(
                [self.counters[r] for r in QUARANTINE_REASONS], np.int64),
            "scalars": np.asarray(
                [self.submitted, self.admitted, self.repaired_order,
                 self._seq], np.int64),
            "last_obj": np.asarray(objs, np.int64),
            "last_fix": np.asarray(
                [self._last[o] for o in objs], np.float64).reshape(-1, 3),
            "log_seq": np.asarray([e[0] for e in log], np.int64),
            "log_obj": np.asarray([e[1] for e in log], np.int64),
            "log_t": np.asarray([e[2] for e in log], np.float64),
            "log_code": np.asarray([e[3] for e in log], np.int64),
        }

    def load_state_arrays(self, st: dict):
        self.counters = {r: int(c) for r, c in
                         zip(QUARANTINE_REASONS, st["counters"])}
        self.submitted, self.admitted, self.repaired_order, self._seq = (
            int(v) for v in st["scalars"])
        self._last = {int(o): tuple(float(v) for v in fix)
                      for o, fix in zip(st["last_obj"],
                                        st["last_fix"].reshape(-1, 3))}
        self._log = [(int(s), int(o), float(t), int(c))
                     for s, o, t, c in zip(st["log_seq"], st["log_obj"],
                                           st["log_t"], st["log_code"])]
