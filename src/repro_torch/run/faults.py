"""Deterministic fault injection for the resilient runner (DESIGN.md §10).

The port's copy of ``repro.run.faults`` (plain Python and numpy).

A :class:`FaultPlan` scripts failures the way :class:`repro_torch.core.plan.
EnginePlan` scripts engines: one frozen, JSON-serializable dataclass that a
test (or the launcher's ``--fault-plan``) hands to the runner, which then
fails *identically* on every run — chaos testing without nondeterminism.

Supported faults, all keyed on the runner's stage boundaries:

* ``crash_at=<stage>`` — raise :class:`InjectedCrash` on entry to the
  stage, i.e. after the previous stage's checkpoint landed; a subsequent
  resume must reproduce the uninterrupted run bit for bit.
* ``transient_at=<stage>`` + ``transient_count=N`` — the stage raises
  :class:`TransientFault` on its first N attempts and succeeds on attempt
  N+1, exercising :func:`retry_with_backoff` (and, for N > max_retries,
  the :class:`RetriesExhausted` path).
* ``corrupt_stage=<stage>`` (+ ``corrupt_leaf``) — after the stage's
  checkpoint is written, flip bytes in one stored leaf while leaving the
  manifest CRC stale, so the next restore detects the mismatch and falls
  back a step.
* ``slow=((stage, partition, seconds), ...)`` — add scripted wall time to
  a (stage, partition) cell of the timing matrix the straggler monitor
  consumes, so flagging and rebalance suggestions are testable without
  real slow hardware.

Stream chaos (DESIGN.md §13.6) — the same plan scripts the streaming
service's failure modes, keyed on the *submission batch index* (so a
resumed run, which replays batches by absolute index, re-applies the
identical transforms):

* ``stream_late_burst=((batch, seconds), ...)`` — shift every record of
  submission ``batch`` back in time by ``seconds`` (a late burst that the
  watermark must count/drop or scoped-rejoin).
* ``stream_dup_storm=(batch, ...)`` — duplicate every record of the
  submission (quarantined as ``duplicate``).
* ``stream_poison=((batch, index), ...)`` — overwrite record ``index`` of
  the submission with NaN coordinates (a poison record).
* ``stream_stall=(batch, ...)`` — suppress the window advance after this
  submission (queue pressure / stalled-watermark scenarios).
* ``crash_at_advance=N`` (>= 0) — raise :class:`InjectedCrash` on entry
  to window advance ``N``, after the previous advance's snapshot landed;
  the kill-and-resume parity suite drives this.

Retry timing is injectable (``sleep=``/monotonic ``clock=``), so the
exponential-backoff schedule is asserted in tests with zero real sleeping.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Optional

import numpy as np

_STAGES = ("join", "segment", "similarity", "cluster", "refine")


class InjectedCrash(RuntimeError):
    """A scripted hard crash (process death) at a stage boundary."""


class TransientFault(RuntimeError):
    """A scripted recoverable failure (lost worker, flaky collective)."""


class RetriesExhausted(RuntimeError):
    """``retry_with_backoff`` gave up after ``max_retries`` attempts."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One deterministic failure script for a resilient run."""

    crash_at: str | None = None        # stage to die on entry to
    transient_at: str | None = None    # stage that fails transiently...
    transient_count: int = 0           # ...on its first N attempts
    corrupt_stage: str | None = None   # corrupt this stage's checkpoint
    corrupt_leaf: int = 0              # which stored leaf file to damage
    slow: tuple = ()                   # ((stage, partition, seconds), ...)
    # --- stream chaos (keyed on absolute submission-batch index) ---
    stream_late_burst: tuple = ()      # ((batch, seconds), ...)
    stream_dup_storm: tuple = ()       # (batch, ...)
    stream_poison: tuple = ()          # ((batch, record_index), ...)
    stream_stall: tuple = ()           # (batch, ...) — skip the advance
    crash_at_advance: int = -1         # die entering this window advance

    # ------------------------------------------------------------------ api
    def validate(self) -> "FaultPlan":
        for name in ("crash_at", "transient_at", "corrupt_stage"):
            v = getattr(self, name)
            if v is not None and v not in _STAGES:
                raise ValueError(f"{name}={v!r}: expected one of {_STAGES}")
        if not isinstance(self.transient_count, int) or \
                self.transient_count < 0:
            raise ValueError("transient_count must be a non-negative int, "
                             f"got {self.transient_count!r}")
        if self.transient_count and self.transient_at is None:
            raise ValueError("transient_count without transient_at")
        if not isinstance(self.corrupt_leaf, int) or self.corrupt_leaf < 0:
            raise ValueError("corrupt_leaf must be a non-negative int, "
                             f"got {self.corrupt_leaf!r}")
        for entry in self.slow:
            if (len(tuple(entry)) != 3 or tuple(entry)[0] not in _STAGES):
                raise ValueError(f"slow entry {entry!r}: expected "
                                 "(stage, partition, seconds)")
        for name, width in (("stream_late_burst", 2), ("stream_poison", 2)):
            for entry in getattr(self, name):
                e = tuple(entry)
                if len(e) != width or int(e[0]) < 0:
                    raise ValueError(f"{name} entry {entry!r}: expected "
                                     f"a {width}-tuple keyed on a "
                                     "non-negative batch index")
        for name in ("stream_dup_storm", "stream_stall"):
            for b in getattr(self, name):
                if int(b) < 0:
                    raise ValueError(f"{name} entry {b!r}: expected a "
                                     "non-negative batch index")
        if not isinstance(self.crash_at_advance, int) or \
                self.crash_at_advance < -1:
            raise ValueError("crash_at_advance must be an int >= -1 "
                             f"(-1 disables), got {self.crash_at_advance!r}")
        return self

    def replace(self, **kw) -> "FaultPlan":
        return dataclasses.replace(self, **kw).validate()

    def slowdown(self, stage: str, partition: int) -> float:
        """Scripted extra seconds for a (stage, partition) cell."""
        return sum(float(s) for st, p, s in self.slow
                   if st == stage and int(p) == int(partition))

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for name in ("slow", "stream_late_burst", "stream_poison"):
            d[name] = [list(e) for e in getattr(self, name)]
        for name in ("stream_dup_storm", "stream_stall"):
            d[name] = [int(b) for b in getattr(self, name)]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        """Strict inverse of ``to_dict``: unknown keys raise (same contract
        as ``EnginePlan.from_dict``); missing keys take field defaults."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown FaultPlan fields {sorted(unknown)}; "
                             f"known fields: {sorted(names)}")
        d = dict(d)
        for name in ("slow", "stream_late_burst", "stream_poison"):
            if name in d:
                d[name] = tuple(tuple(e) for e in d[name])
        for name in ("stream_dup_storm", "stream_stall"):
            if name in d:
                d[name] = tuple(int(b) for b in d[name])
        return cls(**d).validate()

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())


class FaultInjector:
    """Executes a :class:`FaultPlan` against the runner's stage hooks.

    The injector is stateful per *process* (transient attempt counts),
    while the plan is stateful per *run directory* via the checkpoints —
    matching the real failure model: a transient fault retries in-process,
    a crash kills the process and a new injector starts clean on resume.
    """

    def __init__(self, plan: FaultPlan | None):
        self.plan = plan or FaultPlan()
        self._attempts: dict[str, int] = {}

    def on_stage_enter(self, stage: str) -> None:
        """Raise the scripted failure for this stage, if any."""
        if self.plan.crash_at == stage:
            raise InjectedCrash(f"injected crash at stage {stage!r}")
        if self.plan.transient_at == stage:
            n = self._attempts.get(stage, 0)
            self._attempts[stage] = n + 1
            if n < self.plan.transient_count:
                raise TransientFault(
                    f"injected transient failure at stage {stage!r} "
                    f"(attempt {n + 1}/{self.plan.transient_count})")

    def on_checkpoint_written(self, stage: str, step_dir) -> bool:
        """Damage the stage's freshly-written checkpoint if scripted.
        Returns True when corruption was injected."""
        if self.plan.corrupt_stage != stage:
            return False
        leaves = sorted(Path(step_dir).glob("leaf_*.npy"))
        target = leaves[min(self.plan.corrupt_leaf, len(leaves) - 1)]
        blob = bytearray(target.read_bytes())
        # flip bits in the tail so the .npy header still parses and only
        # the CRC (not the loader) notices
        blob[-1] ^= 0xFF
        blob[len(blob) // 2] ^= 0xFF
        target.write_bytes(bytes(blob))
        return True

    def slowdown(self, stage: str, partition: int) -> float:
        return self.plan.slowdown(stage, partition)

    # ------------------------------------------------------------ stream hooks
    def on_stream_batch(self, batch_idx: int, recs):
        """Apply the scripted dirty-stream transforms to submission
        ``batch_idx`` (pure function of (plan, batch_idx, recs) — a
        resumed run replaying the same batch reproduces the same dirt).
        ``recs`` is a ``repro_torch.stream.ingest.Records``; returns the same
        type."""
        from repro_torch.stream.ingest import Records, concat_records
        obj = np.array(recs.obj, np.int32)
        x = np.array(recs.x, np.float32)
        y = np.array(recs.y, np.float32)
        t = np.array(recs.t, np.float32)
        for b, seconds in self.plan.stream_late_burst:
            if int(b) == batch_idx:
                t = t - np.float32(seconds)
        for b, idx in self.plan.stream_poison:
            if int(b) == batch_idx and recs.n:
                x[int(idx) % recs.n] = np.nan
                y[int(idx) % recs.n] = np.nan
        out = Records(obj, x, y, t)
        if batch_idx in {int(b) for b in self.plan.stream_dup_storm}:
            out = concat_records([out, out])
        return out

    def stall_batch(self, batch_idx: int) -> bool:
        """True when the scripted queue-pressure slowdown suppresses the
        window advance after submission ``batch_idx``."""
        return batch_idx in {int(b) for b in self.plan.stream_stall}

    def on_window_advance(self, advance_idx: int) -> None:
        """Raise the scripted crash on entry to window advance
        ``advance_idx`` (after the previous advance's snapshot landed)."""
        if self.plan.crash_at_advance == advance_idx:
            raise InjectedCrash(
                f"injected crash at window advance {advance_idx}")


def retry_with_backoff(fn: Callable, *, max_retries: int = 3,
                       base_delay: float = 0.5, max_delay: float = 30.0,
                       sleep: Optional[Callable[[float], None]] = None,
                       retry_on: tuple = (TransientFault,),
                       on_retry: Optional[Callable] = None):
    """Call ``fn()`` with bounded exponential backoff on transient errors.

    Delay before attempt ``i`` (1-based retries) is
    ``min(base_delay * 2**(i-1), max_delay)``.  ``sleep`` is injectable so
    tests assert the schedule against a recording fake instead of waiting;
    ``on_retry(attempt, delay, exc)`` feeds the runner's telemetry.
    Raises :class:`RetriesExhausted` (chaining the last error) after
    ``max_retries`` failed retries.
    """
    if sleep is None:                                   # pragma: no cover
        import time
        sleep = time.sleep
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            attempt += 1
            if attempt > max_retries:
                raise RetriesExhausted(
                    f"gave up after {max_retries} retries: {e}") from e
            delay = min(base_delay * 2.0 ** (attempt - 1), max_delay)
            if on_retry is not None:
                on_retry(attempt, delay, e)
            sleep(delay)
