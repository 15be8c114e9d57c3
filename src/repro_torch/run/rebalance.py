"""Straggler-driven adaptive repartitioning policy (DESIGN.md §11).

The port's copy of ``repro.run.rebalance`` (plain Python and numpy).

A :class:`RebalancePolicy` closes the straggler loop: the
``StragglerMonitor`` flags slow partitions and the reference's
``suggest_rebalance_edges`` computes a slowdown-weighted equi-depth
re-cut (multi-device only); the policy — one frozen,
JSON-serializable dataclass in the :class:`repro_torch.run.faults.FaultPlan`
idiom — tells the resilient stage runner what to do with those flags:

* ``mode="off"``      — ignore straggler flags entirely (no suggestion
  telemetry either).
* ``mode="suggest"``  — (default) emit ``rebalance_suggestion`` events
  with the proposed edges; never touch the layout.
* ``mode="apply"``    — once ``consecutive`` successive stages flag a
  straggler (and at most ``max_applies`` times per run), re-cut the
  partitioned batch at the suggested edges, repartition all in-flight
  per-point stage state through the canonical global form
  (``repro_torch.core.partitioning.repartition``; multi-device only),
  rebuild the stage
  programs, checkpoint the post-rebalance state, and emit a
  ``rebalanced`` event carrying the applied edges.

Application only happens at the join/segment stage boundaries: later
stages carry partition-bound state (per-partition subtrajectory moments
and labels) that has no partition-free form — see DESIGN.md §11.  The
rebalanced run is bit-identical to a straight-through run partitioned
at the applied cut from the start.
"""
from __future__ import annotations

import dataclasses
import json

_MODES = ("off", "suggest", "apply")


@dataclasses.dataclass(frozen=True)
class RebalancePolicy:
    """What the stage runner does with straggler flags."""

    mode: str = "suggest"      # off | suggest | apply
    consecutive: int = 1       # flagged stages in a row before applying
    max_applies: int = 1       # applied re-cuts per run

    # ------------------------------------------------------------------ api
    def validate(self) -> "RebalancePolicy":
        if self.mode not in _MODES:
            raise ValueError(f"mode={self.mode!r}: expected one of {_MODES}")
        if not isinstance(self.consecutive, int) or self.consecutive < 1:
            raise ValueError("consecutive must be a positive int, "
                             f"got {self.consecutive!r}")
        if not isinstance(self.max_applies, int) or self.max_applies < 0:
            raise ValueError("max_applies must be a non-negative int, "
                             f"got {self.max_applies!r}")
        return self

    def replace(self, **kw) -> "RebalancePolicy":
        return dataclasses.replace(self, **kw).validate()

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RebalancePolicy":
        """Strict inverse of ``to_dict``: unknown keys raise (same contract
        as ``FaultPlan.from_dict``); missing keys take field defaults."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(
                f"unknown RebalancePolicy fields {sorted(unknown)}; "
                f"known fields: {sorted(names)}")
        return cls(**d).validate()

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RebalancePolicy":
        return cls.from_dict(json.loads(s))

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "RebalancePolicy":
        with open(path) as f:
            return cls.from_json(f.read())
