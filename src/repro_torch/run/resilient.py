"""Stage-resumable resilient DSC runner on one device (counterpart of
``repro.run.resilient``; DESIGN.md §10).

The DSC pipeline decomposes into five checkpointable stage boundaries:

    join/vote -> segment/table -> similarity -> cluster -> refine

Each stage calls the port's stage entry points (``repro_torch.core.dsc.
run_stage_*``, the same bodies ``run_dsc`` runs), persists its outputs
as a flat ``{name: array}`` checkpoint through the atomic CRC-verified
:class:`repro_torch.checkpoint.CheckpointManager`, and a rerun resumes
from the first incomplete stage with final labels / SSCR / RMSE
bit-identical to a straight-through run.

Checkpoints are *cumulative*: step k holds the full state after stages
1..k, so a resume needs only the newest readable step.  Restores descend
from the newest step and fall back one step per corrupt checkpoint
(``on_corruption="fallback"``; ``"fail"`` raises
:class:`CheckpointCorruption` instead — the launcher maps it to its own
exit code).  The state keys, dtypes and file format are the reference's
(the packed TSA2 words, int32 bit patterns in the port, are stored as the
reference's uint32), so a run crashed in one package resumes in the
other.

The loop state holds each stage's outputs as tensors on the run's
device: torch donates no buffer, so nothing has to be copied to the host
between stages (the reference lands every output on the host because its
stage programs donate their inputs).  A save copies the state to the
host on the calling thread (``CheckpointManager.save_async``) and writes
it on a worker thread while the next stage runs; a restored leaf goes
back to the run's device.

Failure-class exit codes (``EXIT_CODES``) are what
``repro_torch.launch.run_dsc`` returns to the OS.  Top-K certificate
violations follow ``on_overflow``:

* ``"widen"``  (default) — drop the similarity/cluster/refine state,
  double K, and re-run *only* those stages from the checkpointed
  join/segment state.
* ``"raise"``  — raise :class:`OverflowViolation`.
* ``"degrade"`` — finish with truncated lists; the violation count stays
  in ``sim_overflow`` and is telemetried.

Per-stage wall timings (plus any :class:`repro_torch.run.faults.
FaultPlan` scripted slowdowns) feed the :class:`repro_torch.distributed.
straggler.StragglerMonitor`; what happens to a flag is the
:class:`repro_torch.run.rebalance.RebalancePolicy`'s call — emit a
``suggest_rebalance_edges`` re-cut suggestion (the default), or *apply*
it: repartition the batch and the in-flight per-point stage state at the
new cut, rebuild the stage programs, and checkpoint the post-rebalance
state (``rebalanced`` event).  One partition has no re-cut to suggest or
apply.  Everything is emitted as JSONL telemetry next to the checkpoints,
event for event the reference's.

The multi-device runner (``run_resilient_distributed``) drives the stage
programs of ``repro_torch.core.distributed.build_dsc_stage_programs``.
Those run on every rank of the mesh together and return the global ``[P,
...]`` arrays on every rank, so the whole stage loop runs on every rank,
inside one ``spawn``.  Where the reference has one process, the port has
``P * M``, and three rules keep them one run:

* every decision agrees on every rank (a rank that widened or rebalanced
  alone would hang the others in a collective): the overflow counts come
  from the gathered ``diag``; the straggler monitor is fed one wall a
  stage, the max over the ranks; retries and injected faults are
  deterministic and raise at stage entry, before any collective;
* one writer: rank 0 alone writes checkpoints and ``telemetry.jsonl``,
  injects checkpoint corruption and runs the async writer thread; every
  rank restores from the directory itself (a CRC decides corruption the
  same way everywhere), then all ranks pass a barrier before rank 0 may
  rewrite or prune a step, and another barrier ends every run, so a run
  that follows on the same ranks restores only after rank 0's last save
  has landed;
* the runner's own failures (``InjectedCrash``, ``RetriesExhausted``,
  ``OverflowViolation``, ``CheckpointCorruption`` and the elastic
  ``ValueError``) come back from the ranks as values, after the in-flight
  save has landed, and the parent re-raises rank 0's with its class and
  message (``spawn`` would turn them into a ``RuntimeError``).

Distributed checkpoints also record the layout (``meta/*`` leaves: cut
edges, the global point set, the model-axis width), so
``elastic_resume=True`` restores them onto a mesh with another partition
count: the join / segment state folds to global point space and re-cuts
for the new P (``repro_torch.core.partitioning.repartition``), later
stages rewind to the segment boundary, and the finished run is bitwise a
straight run at the new P (DESIGN.md §11).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpointer import to_host
from repro_torch.core import dsc as dsc_mod
from repro_torch.core.clustering import rmse_from_result, sscr_from_result
from repro_torch.core.partitioning import (PointLayout, _np, repartition,
                                           repartition_batch)
from repro_torch.core.plan import EnginePlan, resolve_plan
from repro_torch.core.types import (ClusteringResult, JoinResult,
                                    SubtrajSegmentation, SubtrajTable,
                                    TopKSim)
from repro_torch.distributed.straggler import (StragglerMonitor,
                                               suggest_rebalance_edges)
from repro_torch.run.faults import (FaultInjector, FaultPlan, InjectedCrash,
                                    RetriesExhausted, retry_with_backoff)
from repro_torch.run.rebalance import RebalancePolicy
from repro_torch.utils.logging import get_logger

log = get_logger("resilient")

STAGES = ("join", "segment", "similarity", "cluster", "refine")

# process exit code per failure class (the launcher returns these)
EXIT_CODES = {
    "ok": 0,
    "error": 1,
    "overflow": 3,
    "corruption": 4,
    "retries_exhausted": 5,
    "injected_crash": 6,
    "poison": 7,          # PoisonRecord under on_dirty="fail" (stream)
    "backpressure": 8,    # BackpressureOverflow / WatermarkStall (stream)
}


class CheckpointCorruption(RuntimeError):
    """A checkpoint failed CRC/shape/dtype verification and the policy is
    ``on_corruption="fail"``."""


class OverflowViolation(RuntimeError):
    """Top-K spill certificate violated under ``on_overflow="raise"``."""


# state keys owned by each stage (prefix match) — a widen drops exactly
# the similarity-and-later keys and re-runs from the segment checkpoint
_STAGE_KEYS = {
    "join": ("vote", "masks", "join/"),
    "segment": ("seg/", "table/", "labels"),
    "similarity": ("sim", "topk/", "moments/", "active"),
    "cluster": ("result/", "res/", "overflow", "diag"),
    "refine": ("final/", "sscr", "rmse"),
}

# leaves of packed TSA2 words: int32 bit patterns in the port, uint32 in
# the reference's checkpoints (saved and restored as the reference's)
_WORD_LEAVES = ("masks",)

# the repartitionable subset of the distributed state: per-point leaves
# ([P, T, Mp, ...] in the partition layout) and the halo-slab-indexed
# join cube.  Everything else either is layout-free (the replicated
# table) or partition-bound (similarity onward — no partition-free form;
# elastic adaptation rewinds past it instead).
_POINT_LEAVES = ("vote", "masks", "labels", "join/best_w")
_CAND_IDX_LEAVES = ("join/best_idx",)

TELEMETRY_SCHEMA = 1


@dataclasses.dataclass
class ResilientResult:
    """What a resilient run hands back to the caller / launcher."""
    output: Any                    # DSCOutput | DistributedDSCOutput
    sscr: float
    rmse: float
    resumed_from: int              # completed stages found on disk (0=fresh)
    widen_count: int               # overflow-policy re-runs performed
    fallback_steps: list           # checkpoint steps discarded as corrupt
    events: list                   # telemetry events (also JSONL'd)
    rebalance_count: int = 0       # straggler re-cuts applied


class _Telemetry:
    """Append-only JSONL event stream + in-memory copy.

    Every event is flushed *and fsynced* before ``emit`` returns, so a
    crash loses at most the line being written — and
    :func:`read_telemetry` tolerates exactly that torn final line.
    """

    def __init__(self, path: Optional[Path], clock: Callable[[], float]):
        self.path = Path(path) if path is not None else None
        self.clock = clock
        self.events: list[dict] = []

    def emit(self, event: str, **fields):
        ev = {"schema": TELEMETRY_SCHEMA,
              "ts": round(float(self.clock()), 6), "event": event, **fields}
        self.events.append(ev)
        if self.path is not None:
            with open(self.path, "a") as f:
                f.write(json.dumps(ev) + "\n")
                f.flush()
                os.fsync(f.fileno())


# public name: the streaming service writes its events through the same
# fsynced JSONL writer and schema as the batch runner
Telemetry = _Telemetry


def read_telemetry(path) -> list[dict]:
    """Parse a ``telemetry.jsonl`` stream, tolerating a truncated final
    line (the crash-mid-write window ``_Telemetry``'s per-event fsync
    leaves open).  Damage anywhere *before* the final line still raises
    ``ValueError`` — that is corruption, not a torn tail."""
    with open(path) as f:
        lines = f.read().split("\n")
    if lines and lines[-1] == "":
        lines.pop()                    # well-terminated file
    events: list[dict] = []
    for i, line in enumerate(lines):
        try:
            events.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break                  # torn final line: drop it
            raise ValueError(
                f"{path}: malformed telemetry at line {i + 1}") from None
    return events


def _drop_stage_keys(state: dict, stages) -> dict:
    prefixes = tuple(p for s in stages for p in _STAGE_KEYS[s])
    return {k: v for k, v in state.items()
            if not any(k == p or k.startswith(p) for p in prefixes)}


def _restore_with_fallback(mgr: CheckpointManager, on_corruption: str,
                           tel: _Telemetry):
    """Newest readable checkpoint, falling back a step per corrupt one.
    Returns ``(state, step, discarded_steps)`` — ``({}, 0, [...])`` when
    nothing (intact) is on disk.  The state is host numpy."""
    discarded: list[int] = []
    for step in sorted(mgr.available_steps(), reverse=True):
        try:
            state, _ = mgr.restore_flat(step)
            return state, step, discarded
        except (IOError, EOFError, ValueError, KeyError,
                json.JSONDecodeError) as e:
            # EOFError/OSError cover a *truncated* leaf file (np.load
            # dies before the CRC check ever sees the short buffer)
            if on_corruption == "fail":
                raise CheckpointCorruption(
                    f"checkpoint step {step} failed verification: {e}"
                ) from e
            discarded.append(step)
            tel.emit("checkpoint_fallback", step=step, error=str(e))
            log.warning("checkpoint step %d corrupt (%s); falling back",
                        step, e)
    return {}, 0, discarded


def _check_policies(on_overflow: str, on_corruption: str):
    if on_overflow not in ("raise", "widen", "degrade"):
        raise ValueError(f"on_overflow={on_overflow!r}: expected "
                         "'raise', 'widen', or 'degrade'")
    if on_corruption not in ("fallback", "fail"):
        raise ValueError(f"on_corruption={on_corruption!r}: expected "
                         "'fallback' or 'fail'")


def _to_device(state: dict, device: torch.device) -> dict:
    """Restored host leaves as tensors on the run's device (the packed
    words back to int32 bit patterns)."""
    out = {}
    for k, v in state.items():
        if k in _WORD_LEAVES and v.dtype == np.uint32:
            v = v.view(np.int32)
        out[k] = torch.from_numpy(v).to(device)
    return out


class _StageLoop:
    """The stage-graph executor shared by the single-device and
    distributed runners: checkpointing, resume, retries, fault hooks,
    overflow policy, and straggler telemetry.  A subclass provides the
    stage bodies (``stage_<name>``) and the per-run geometry.  ``writer``
    is false on the ranks other than rank 0 of a mesh: they restore from
    the checkpoint directory but write neither checkpoints nor
    telemetry."""

    def __init__(self, *, plan: EnginePlan, checkpoint_dir, on_overflow,
                 on_corruption, fault_plan, max_retries, sleep, clock,
                 monitor, n_partitions: int, S: int, device: torch.device,
                 rebalance: RebalancePolicy | None = None,
                 sync_saves: bool = False, writer: bool = True):
        _check_policies(on_overflow, on_corruption)
        self.plan = plan
        self.on_overflow = on_overflow
        self.on_corruption = on_corruption
        self.injector = FaultInjector(fault_plan)
        bad = sorted({int(p) for _, p, _ in self.injector.plan.slow
                      if not 0 <= int(p) < n_partitions})
        if bad:
            raise ValueError(
                f"FaultPlan.slow references partition(s) {bad} but this "
                f"run has {n_partitions} partition(s) (valid indices "
                f"0..{n_partitions - 1})")
        self.max_retries = max_retries
        self.sleep = sleep
        self.clock = clock if clock is not None else time.perf_counter
        self.nP = n_partitions
        self.S = S
        self.device = device
        self.sync_saves = sync_saves
        self.writer = writer
        self.rebalance = (rebalance if rebalance is not None
                          else RebalancePolicy()).validate()
        self.mgr = None
        tel_path = None
        if checkpoint_dir is not None:
            self.mgr = CheckpointManager(checkpoint_dir,
                                         keep_n=len(STAGES) + 1)
            self.mgr.root.mkdir(parents=True, exist_ok=True)
            if writer:
                tel_path = self.mgr.root / "telemetry.jsonl"
        self.tel = _Telemetry(tel_path, self.clock)
        self.monitor = monitor if monitor is not None else \
            StragglerMonitor(n_partitions)
        self.widen_count = 0
        self.rebalance_count = 0
        self._flag_streak = 0
        self._last_flagged: dict[int, float] = {}

    # ---- hooks a subclass provides -----------------------------------
    def rebalance_inputs(self):
        """``(times, part_of)`` of all valid points, or None (P == 1)."""
        return None

    def current_k(self, state: dict) -> int:
        """K of the top-K lists currently in ``state`` (or planned)."""
        if "topk/ids" in state:
            return int(state["topk/ids"].shape[-1])
        k = (self.plan.sim_topk if self.plan.sim_topk is not None
             else dsc_mod.DEFAULT_TOPK)
        return min(k, self.S)

    def overflow_count(self, state: dict) -> int:
        raise NotImplementedError

    def _table_of(self, state):
        return SubtrajTable(
            t_start=state["table/t_start"], t_end=state["table/t_end"],
            voting=state["table/voting"], card=state["table/card"],
            valid=state["table/valid"], traj_row=state["table/traj_row"])

    def agreed_wall(self, wall: float) -> float:
        """The stage wall every partition's straggler series records (one
        process: its own)."""
        return wall

    # ---- elastic / rebalance hooks (distributed loop overrides) ------
    def extra_leaves(self) -> dict:
        """Layout-metadata leaves merged into every checkpoint save."""
        return {}

    def adapt_restored_state(self, state: dict, done: int):
        """Map a restored checkpoint (host numpy leaves) onto this run's
        layout.  The base runner has no layout: just strip the ``meta/*``
        leaves that ``extra_leaves`` (here or in the reference) added."""
        return {k: v for k, v in state.items()
                if not k.startswith("meta/")}, done

    def _maybe_rebalance(self, stage: str, step: int, state: dict):
        return state

    def on_plan_widened(self):
        """Subclass hook: rebuild anything keyed on plan.sim_topk."""

    # ---- executor ----------------------------------------------------
    def _comm_schedule(self) -> dict:
        """The plan's communication schedules, stamped on every
        straggler-relevant telemetry event as the reference does (one
        device runs no collective; the fields are the plan's)."""
        return {"halo_stream": self.plan.halo_stream,
                "sim_exchange": self.plan.sim_exchange}

    def _run_stage(self, stage: str, state: dict) -> dict:
        def attempt():
            self.injector.on_stage_enter(stage)
            return getattr(self, f"stage_{stage}")(state)

        def on_retry(n, delay, exc):
            self.tel.emit("retry", stage=stage, attempt=n,
                          delay_s=delay, error=str(exc))

        t0 = self.clock()
        updates = retry_with_backoff(attempt, max_retries=self.max_retries,
                                     sleep=self.sleep, on_retry=on_retry)
        wall = self.agreed_wall(self.clock() - t0)
        times = [wall + self.injector.slowdown(stage, p)
                 for p in range(self.nP)]
        self.monitor.record_all(times)
        flagged = self.monitor.check()
        self.tel.emit("stage_done", stage=stage,
                      step=STAGES.index(stage) + 1, wall_s=round(wall, 6),
                      per_partition_s=[round(t, 6) for t in times],
                      comm=self._comm_schedule())
        self._flag_streak = self._flag_streak + 1 if flagged else 0
        self._last_flagged = dict(flagged)
        if flagged:
            self.tel.emit("straggler_flagged",
                          stage=stage, partitions={
                              str(p): round(r, 3)
                              for p, r in flagged.items()},
                          comm=self._comm_schedule())
            ri = self.rebalance_inputs() \
                if self.rebalance.mode != "off" else None
            if ri is not None:
                edges = suggest_rebalance_edges(ri[0], ri[1], flagged,
                                                self.nP)
                self.tel.emit("rebalance_suggestion",
                              stage=stage, edges=[
                                  float(e) for e in edges])
        state = dict(state)
        state.update(updates)
        return state

    def _host_tree(self, state: dict) -> dict:
        """The state as the checkpoint stores it: host copies, packed
        words as the reference's uint32."""
        tree = {}
        for k, v in state.items():
            arr = to_host(v)
            tree[k] = arr.view(np.uint32) if k in _WORD_LEAVES else arr
        return tree

    def _save(self, step: int, stage: str, state: dict):
        if self.mgr is None or not self.writer:
            return
        tree = self._host_tree(state)
        tree.update(self.extra_leaves())
        if self.sync_saves:
            self.mgr.save(step, tree)
        else:
            # async: the host copy is made here; the write of step k
            # overlaps stage k+1, and every save / restore / injection
            # point barriers through mgr.wait()
            self.mgr.save_async(step, tree)
        if self.injector.plan.corrupt_stage == stage:
            self.mgr.wait()     # injection edits files: land them first
            if self.injector.on_checkpoint_written(stage,
                                                   self.mgr.step_dir(step)):
                self.tel.emit("checkpoint_corrupted_injected", stage=stage,
                              step=step)

    def _apply_overflow_policy(self, state, done):
        """Check the spill certificate once the cluster stage is in
        ``state`` (whether it just ran or was restored) and apply
        ``on_overflow``.  Returns ``(state, done)`` — rewound to the
        segment checkpoint for a widen."""
        if (self.plan.sim_mode != "topk"
                or done < STAGES.index("cluster") + 1):
            return state, done
        overflow = self.overflow_count(state)
        if overflow == 0:
            return state, done
        k = self.current_k(state)
        if self.on_overflow == "degrade":
            self.tel.emit("overflow_degraded", k=k, rows=overflow)
            return state, done
        if self.on_overflow == "raise":
            raise OverflowViolation(
                f"sim_topk={k} truncated a potential alpha-edge on "
                f"{overflow} rows (spill >= alpha): labels would not be "
                "exact.  Raise sim_topk or use on_overflow='widen'.")
        if k >= self.S:       # unreachable: K == S cannot spill
            raise AssertionError("overflow with K == S")
        # stage-level widen: similarity onward re-runs from the
        # checkpointed segment state with K doubled
        new_k = min(2 * k, self.S)
        self.widen_count += 1
        self.tel.emit("widen", k_from=k, k_to=new_k, rows=overflow)
        self.plan = self.plan.replace(sim_topk=new_k)
        self.on_plan_widened()
        state = _drop_stage_keys(state,
                                 ("similarity", "cluster", "refine"))
        return state, STAGES.index("segment") + 1

    def run(self):
        try:
            out = self._execute()
        except BaseException:
            # an in-flight async save must land even when the run dies:
            # the resume point is defined by the last *completed* stage,
            # and its checkpoint may still be on the writer thread
            if self.mgr is not None:
                try:
                    self.mgr.wait()
                except Exception as e:  # noqa: BLE001 — crash path
                    log.warning("async save failed during crash: %s", e)
            raise
        if self.mgr is not None:
            self.mgr.wait()     # surface async save errors before return
        return out

    def _execute(self):
        if self.mgr is not None:
            state, done, discarded = _restore_with_fallback(
                self.mgr, self.on_corruption, self.tel)
        else:
            state, done, discarded = {}, 0, []
        state, done = self.adapt_restored_state(state, done)
        state = _to_device(state, self.device)
        resumed_from = done
        self.tel.emit("run_start", resumed_from_step=done,
                      plan_sim_mode=self.plan.sim_mode,
                      on_overflow=self.on_overflow)
        # a crash may have landed between the cluster checkpoint and the
        # widen re-run it demanded — re-apply the policy to restored state
        state, done = self._apply_overflow_policy(state, done)
        while True:
            for step in range(done + 1, len(STAGES) + 1):
                stage = STAGES[step - 1]
                state = self._run_stage(stage, state)
                state = self._maybe_rebalance(stage, step, state)
                self._save(step, stage, state)
                done = step
                if stage == "cluster":
                    state, done = self._apply_overflow_policy(state, done)
                    if done < step:
                        break               # widened: rewind to segment
            else:
                break
        self.tel.emit("run_done", widen_count=self.widen_count)
        return state, resumed_from, discarded


# ===================================================================== #
# single-host                                                           #
# ===================================================================== #


class _SingleHostLoop(_StageLoop):
    def __init__(self, batch, params, **kw):
        self.batch = batch
        self.params = params
        super().__init__(n_partitions=1,
                         S=batch.num_trajs * params.max_subtrajs_per_traj,
                         device=batch.device, **kw)
        # host-side planning is deterministic, so recomputing it on
        # resume reproduces the original run exactly (never checkpointed)
        self.tile_ids, self.plan = dsc_mod.plan_fused_tile_ids(
            batch, params, self.plan)
        self.plan = self.plan.replace(sim_topk=self.current_k({}))

    def overflow_count(self, state):
        return int(state["overflow"])

    # ---- stage bodies (flat-state in, flat-state updates out) --------
    def stage_join(self, state):
        b, p, plan = self.batch, self.params, self.plan
        if plan.mode == "fused":
            vote, masks = dsc_mod.run_stage_join_fused(
                b, p, tile_ids=self.tile_ids, plan=plan)
            join = None
        elif plan.use_index and plan.use_kernel:
            from repro_torch.kernels.stjoin import ops as stjoin_ops
            join = stjoin_ops.subtrajectory_join(
                b, b, p.eps_sp, p.eps_t, p.delta_t, use_index=True)
            vote, masks = dsc_mod.run_stage_vote_from_join(b, p, join, plan)
        else:
            join, vote, masks = dsc_mod.run_stage_join(b, p, plan)
        out = {"vote": vote}
        if masks is not None:
            out["masks"] = masks
        if join is not None:
            out["join/best_w"] = join.best_w
            out["join/best_idx"] = join.best_idx
        return out

    def _join_of(self, state):
        if "join/best_w" not in state:
            return None
        return JoinResult(best_w=state["join/best_w"],
                          best_idx=state["join/best_idx"])

    def _seg_of(self, state):
        return SubtrajSegmentation(
            cut=state["seg/cut"], sub_local=state["seg/sub_local"],
            num_subs=state["seg/num_subs"], score=state["seg/score"])

    def stage_segment(self, state):
        seg, table = dsc_mod.run_stage_segment(
            self.batch, self.params, state["vote"], state.get("masks"),
            self.plan)
        return {"seg/cut": seg.cut, "seg/sub_local": seg.sub_local,
                "seg/num_subs": seg.num_subs, "seg/score": seg.score,
                "table/t_start": table.t_start,
                "table/t_end": table.t_end, "table/voting": table.voting,
                "table/card": table.card, "table/valid": table.valid,
                "table/traj_row": table.traj_row}

    def stage_similarity(self, state):
        sim, topk = dsc_mod.run_stage_similarity(
            self.batch, self.params, self._join_of(state),
            self._seg_of(state), self._table_of(state),
            tile_ids=self.tile_ids, plan=self.plan)
        if topk is not None:
            return {"topk/ids": topk.ids, "topk/sims": topk.sims,
                    "topk/spill": topk.spill, "topk/degree": topk.degree,
                    "topk/row_sum": topk.row_sum,
                    "topk/row_sumsq": topk.row_sumsq}
        return {"sim": sim}

    def _simlike_of(self, state):
        if "topk/ids" in state:
            return TopKSim(ids=state["topk/ids"], sims=state["topk/sims"],
                           spill=state["topk/spill"],
                           degree=state["topk/degree"],
                           row_sum=state["topk/row_sum"],
                           row_sumsq=state["topk/row_sumsq"])
        return state["sim"]

    def stage_cluster(self, state):
        result, overflow = dsc_mod.run_stage_cluster(
            self._simlike_of(state), self._table_of(state), self.params,
            self.plan)
        if overflow is None:
            overflow = torch.zeros((), dtype=torch.int32,
                                   device=self.device)
        return {"result/member_of": result.member_of,
                "result/member_sim": result.member_sim,
                "result/is_rep": result.is_rep,
                "result/is_outlier": result.is_outlier,
                "result/alpha_used": result.alpha_used,
                "result/k_used": result.k_used,
                "overflow": overflow}

    def _result_of(self, state):
        return ClusteringResult(
            member_of=state["result/member_of"],
            member_sim=state["result/member_sim"],
            is_rep=state["result/is_rep"],
            is_outlier=state["result/is_outlier"],
            alpha_used=state["result/alpha_used"],
            k_used=state["result/k_used"])

    def stage_refine(self, state):
        # single-host stage 5 is the scoring epilogue (there is no
        # cross-partition state to reconcile)
        sscr_v, rmse_v = dsc_mod.run_stage_score(
            self._result_of(state), state.get("sim"), self.params)
        return {"sscr": sscr_v, "rmse": rmse_v}

    def to_output(self, state) -> dsc_mod.DSCOutput:
        topk = self._simlike_of(state) if "topk/ids" in state else None
        return dsc_mod.DSCOutput(
            join=self._join_of(state), vote=state["vote"],
            seg=self._seg_of(state), table=self._table_of(state),
            sim=state.get("sim"), sim_topk=topk,
            sim_overflow=(state["overflow"]
                          if self.plan.sim_mode == "topk" else None),
            result=self._result_of(state), sscr=state["sscr"],
            rmse=state["rmse"], rounds=None,
            dispatches=self.widen_count + 1)


def run_resilient(batch, params, *, plan: EnginePlan | None = None,
                  checkpoint_dir=None, on_overflow: str = "widen",
                  on_corruption: str = "fallback",
                  fault_plan: FaultPlan | None = None,
                  max_retries: int = 3, sleep=None, clock=None,
                  monitor: StragglerMonitor | None = None,
                  rebalance: RebalancePolicy | None = None,
                  sync_saves: bool = False, device=None,
                  **legacy) -> ResilientResult:
    """Single-device resilient run; see the module docstring.

    ``checkpoint_dir=None`` runs the stage graph without persistence
    (faults still inject; resume is impossible).  ``**legacy`` accepts
    the deprecated per-stage flags (``sim_mode=``, ``sim_topk=``, ...) as
    ``repro_torch.core.plan.resolve_plan`` does.  ``device`` (``None`` =
    the card) is where the stages run, as in ``run_dsc``.  The output's
    ``rounds`` is None (a resumed run does not know the rounds of the
    stages it restored); ``dispatches`` counts the similarity passes of
    this run, widens included.
    """
    plan = resolve_plan(plan, **legacy)
    batch = dsc_mod._on_device(batch, device)
    loop = _SingleHostLoop(batch, params, plan=plan,
                           checkpoint_dir=checkpoint_dir,
                           on_overflow=on_overflow,
                           on_corruption=on_corruption,
                           fault_plan=fault_plan, max_retries=max_retries,
                           sleep=sleep, clock=clock, monitor=monitor,
                           rebalance=rebalance, sync_saves=sync_saves)
    state, resumed, discarded = loop.run()
    out = loop.to_output(state)
    return ResilientResult(output=out, sscr=float(out.sscr),
                           rmse=float(out.rmse), resumed_from=resumed,
                           widen_count=loop.widen_count,
                           fallback_steps=discarded,
                           events=loop.tel.events,
                           rebalance_count=loop.rebalance_count)


# ===================================================================== #
# distributed                                                           #
# ===================================================================== #


class _DistributedLoop(_StageLoop):
    """The stage loop on one rank of a mesh (the module docstring's three
    rules).  ``state`` holds the stage programs' global ``[P, ...]``
    outputs, on this rank's device; every rank holds all of it."""

    def __init__(self, parts, params, mesh, part_axis, model_axis, comm,
                 elastic_resume: bool = False, **kw):
        self.params = params
        self.mesh = mesh
        self.part_axis = part_axis
        self.model_axis = model_axis
        self.comm = comm
        self.parts = parts.to(comm.device)
        self.elastic_resume = bool(elastic_resume)
        nP = mesh.shape[part_axis]
        self.nM = mesh.shape[model_axis]
        T = parts.x.shape[1]
        super().__init__(n_partitions=nP,
                         S=T * params.max_subtrajs_per_traj,
                         device=comm.device, writer=comm.rank == 0, **kw)
        try:
            self._layout = PointLayout.from_parts(parts)
        except ValueError:
            self._layout = None     # hand-built batch: no edges/src_m
        if self.elastic_resume and self._layout is None:
            raise ValueError(
                "elastic_resume=True needs a PartitionedBatch produced "
                "by partition_batch/repartition_batch (carrying "
                "edges/src_m); a hand-built batch has no canonical "
                "layout to adapt from")
        self.plan = self.plan.replace(sim_topk=self.current_k({}))
        self._build()

    def run(self):
        """The loop, then a barrier: no rank leaves (and restores again,
        in a run that follows on the same ranks) before rank 0's last save
        has landed.  A failure every rank raises at the same point passes
        the barrier too; another may be this rank's alone and does not
        wait."""
        try:
            out = super().run()
        except _RANK_FAILURES:
            dist.barrier()
            raise
        dist.barrier()
        return out

    def _build(self):
        from repro_torch.core.distributed import build_dsc_stage_programs
        self.progs = build_dsc_stage_programs(
            self.parts, self.params, self.mesh, part_axis=self.part_axis,
            model_axis=self.model_axis, plan=self.plan)

    def on_plan_widened(self):
        self._build()

    def overflow_count(self, state):
        return int(state["diag"][:, 3].sum())

    def agreed_wall(self, wall):
        """The max of the ranks' walls: each rank times its own stage, and
        a flag, a streak or a re-cut must come out the same on every rank
        (one float64 through the mesh, both axes)."""
        self.comm.phase = "wall"
        x = torch.tensor([wall], dtype=torch.float64, device=self.device)
        x = self.comm.all_gather(x, self.part_axis)
        return float(self.comm.all_gather(x, self.model_axis).max())

    def _run_stage(self, stage, state):
        self.comm.phase = stage
        out = super()._run_stage(stage, state)
        if self.comm.host:
            # ranks share one card: hand cached blocks back between stages
            torch.cuda.empty_cache()
        return out

    def rebalance_inputs(self):
        pt = _np(self.parts.t)
        pv = _np(self.parts.valid)
        part_of = np.broadcast_to(
            np.arange(pt.shape[0])[:, None, None], pt.shape)
        return pt[pv], part_of[pv]

    # ---- elastic resume + adaptive repartitioning (DESIGN.md §11) ----
    def extra_leaves(self):
        if self._layout is None:
            return {}
        lay = self._layout
        return {"meta/schema": np.int32(1),
                "meta/edges": np.asarray(lay.edges, np.float64),
                "meta/point_t": np.asarray(lay.t),
                "meta/point_valid": np.asarray(lay.valid),
                "meta/model_width": np.int32(self.nM)}

    def _repartition_state(self, state, old, new):
        """The per-point leaves re-cut from ``old`` to ``new`` (host numpy
        leaves stay numpy, tensors come back on this rank's device)."""
        out = {}
        for k, v in state.items():
            kind = ("point" if k in _POINT_LEAVES else
                    "cand_idx" if k in _CAND_IDX_LEAVES else None)
            if kind is None:
                out[k] = v      # replicated table/* etc. — layout-free
                continue
            r = repartition(v, old, new, kind=kind)
            out[k] = (torch.from_numpy(r).to(self.device)
                      if torch.is_tensor(v) else r)
        return out

    def adapt_restored_state(self, state, done):
        # every rank has read its state: from here on rank 0 may rewrite
        # or prune any step
        dist.barrier()
        meta = {k: np.asarray(v) for k, v in state.items()
                if k.startswith("meta/")}
        state = {k: v for k, v in state.items()
                 if not k.startswith("meta/")}
        if done == 0 or not meta or self._layout is None:
            # pre-elastic checkpoint / hand-built batch: same-mesh
            # resume only (shape mismatches surface downstream)
            return state, done
        old_edges = np.asarray(meta["meta/edges"], np.float64)
        old_P = old_edges.shape[0] - 1
        if old_P != self.nP and not self.elastic_resume:
            raise ValueError(
                f"checkpoint was written at P={old_P} but this mesh has "
                f"P={self.nP}; pass elastic_resume=True "
                "(--elastic-resume) to adapt it")
        new = self._layout
        old_mp = int(np.asarray(state["vote"]).shape[2])
        old = PointLayout.from_global(meta["meta/point_t"],
                                      meta["meta/point_valid"],
                                      old_edges, Mp=old_mp)
        if not old.same_points(new):
            raise ValueError(
                "elastic resume: the checkpoint's global point set "
                "differs from this run's batch — refusing to mix runs")
        if old.same_layout(new):
            return state, done
        old_nm = int(meta["meta/model_width"])
        if old_nm != self.nM:
            raise ValueError(
                f"checkpoint was written with model-axis width {old_nm} "
                f"but this mesh has {self.nM}; only the partition axis "
                "is elastic")
        if old.P == new.P:
            # same partition count, different cut: a crash after an
            # applied rebalance.  Adopt the checkpoint's layout (re-cut
            # the batch at its edges) instead of repartitioning state —
            # the later-stage partition-bound leaves stay valid, so no
            # rewind is needed.
            self.parts = repartition_batch(self.parts, old_edges)
            self._layout = PointLayout.from_parts(self.parts)
            if not self._layout.same_layout(old):
                raise AssertionError("edge adoption did not converge")
            self._build()
            self.tel.emit("elastic_adopt_edges", step=done,
                          edges=[float(e) for e in old_edges])
            return state, done
        # different partition count: fold the join/segment point state
        # to global row space and re-cut it for this mesh.  Similarity
        # onward is partition-bound (per-partition moments feed the
        # alpha/k statistics), so rewind to the segment boundary.
        new_done = min(done, STAGES.index("segment") + 1)
        if new_done < done:
            state = _drop_stage_keys(state, STAGES[new_done:])
        state = self._repartition_state(state, old, new)
        self.tel.emit("elastic_resume", from_partitions=old.P,
                      to_partitions=new.P, from_step=done,
                      to_step=new_done)
        log.info("elastic resume: P=%d checkpoint (step %d) adapted to "
                 "P=%d (step %d)", old.P, done, new.P, new_done)
        return state, new_done

    def _maybe_rebalance(self, stage, step, state):
        pol = self.rebalance
        if (pol.mode != "apply" or not self._last_flagged
                or self._flag_streak < pol.consecutive
                or self.rebalance_count >= pol.max_applies
                or stage not in ("join", "segment")
                or self._layout is None):
            return state
        times, part_of = self.rebalance_inputs()
        edges = np.asarray(
            suggest_rebalance_edges(times, part_of, self._last_flagged,
                                    self.nP), np.float64)
        old = self._layout
        self.parts = repartition_batch(self.parts, edges)
        self._layout = PointLayout.from_parts(self.parts)
        state = self._repartition_state(state, old, self._layout)
        self._build()
        for p in range(self.nP):
            self.monitor.reset(p)
        self._flag_streak = 0
        self._last_flagged = {}
        self.rebalance_count += 1
        self.tel.emit("rebalanced", stage=stage, step=step,
                      applies=self.rebalance_count,
                      edges=[float(e) for e in self._layout.edges],
                      comm=self._comm_schedule())
        log.info("rebalanced after %s at the straggler-weighted cut "
                 "(apply %d/%d)", stage, self.rebalance_count,
                 pol.max_applies)
        return state

    # ---- stage bodies -------------------------------------------------
    def _points(self):
        p = self.parts
        return p.x, p.y, p.t, p.valid, p.traj_id, p.ranges

    def stage_join(self, state):
        st = self.progs["join"](*self._points())
        out = {"vote": st[0], "masks": st[1]}
        if len(st) == 4:
            out["join/best_w"], out["join/best_idx"] = st[2], st[3]
        return out

    def stage_segment(self, state):
        table, labels = self.progs["segment"](
            self.parts.t, self.parts.valid, state["vote"], state["masks"])
        return {"table/t_start": table.t_start,
                "table/t_end": table.t_end, "table/voting": table.voting,
                "table/card": table.card, "table/valid": table.valid,
                "table/traj_row": table.traj_row, "labels": labels}

    def stage_similarity(self, state):
        cube = (() if "join/best_w" not in state else
                (state["join/best_w"], state["join/best_idx"]))
        st = self.progs["similarity"](
            *self._points(), state["labels"], self._table_of(state), *cube)
        if self.plan.sim_mode == "topk":
            ids, sims, spill, degree, rsum, rsumsq, active = st
            return {"topk/ids": ids, "topk/sims": sims,
                    "topk/spill": spill, "topk/degree": degree,
                    "topk/row_sum": rsum, "topk/row_sumsq": rsumsq,
                    "active": active}
        sim, cnt, rsum, rsumsq, active = st
        return {"sim": sim, "moments/cnt": cnt, "moments/rsum": rsum,
                "moments/rsumsq": rsumsq, "active": active}

    def stage_cluster(self, state):
        if self.plan.sim_mode == "topk":
            sim_state = (state["topk/ids"], state["topk/sims"],
                         state["topk/spill"], state["topk/degree"],
                         state["topk/row_sum"], state["topk/row_sumsq"])
        else:
            sim_state = (state["sim"], state["moments/cnt"],
                         state["moments/rsum"], state["moments/rsumsq"])
        member, msim, rep, outl, alpha, k, diag = self.progs["cluster"](
            self._table_of(state), state["active"], *sim_state)
        return {"res/member_of": member, "res/member_sim": msim,
                "res/is_rep": rep, "res/is_outlier": outl,
                "res/alpha": alpha, "res/k": k, "diag": diag}

    def stage_refine(self, state):
        final = self.progs["refine"](
            state["res/member_of"], state["res/member_sim"],
            state["res/is_rep"], state["active"], state["res/alpha"],
            state["res/k"])
        out = {f"final/{f}": getattr(final, f)
               for f in ("member_of", "member_sim", "is_rep",
                         "is_outlier", "alpha_used", "k_used")}
        out["sscr"] = sscr_from_result(final)
        out["rmse"] = rmse_from_result(final, self.params.eps_sp)
        return out

    def to_output(self, state):
        from repro_torch.core.distributed import DistributedDSCOutput
        final = ClusteringResult(
            member_of=state["final/member_of"],
            member_sim=state["final/member_sim"],
            is_rep=state["final/is_rep"],
            is_outlier=state["final/is_outlier"],
            alpha_used=state["final/alpha_used"],
            k_used=state["final/k_used"])
        return DistributedDSCOutput(
            result=final, table=self._table_of(state),
            vote=state["vote"], active=state["active"],
            sim_diag=state["diag"])


# the runner's own failures: raised on every rank at the same point
# (stage entry, the restore, the gathered certificate), so each rank
# returns it as a value and the parent re-raises rank 0's
_RANK_FAILURES = (InjectedCrash, RetriesExhausted, OverflowViolation,
                  CheckpointCorruption, ValueError)


@dataclasses.dataclass
class _RankFailure:
    exc: BaseException


def _rank_run(parts, params, mesh, part_axis, model_axis, kw):
    """``run_resilient_distributed`` on this rank of ``mesh``."""
    from repro_torch.distributed import mesh as mesh_mod
    loop = _DistributedLoop(parts, params, mesh, part_axis, model_axis,
                            mesh_mod.comm_for(mesh), **kw)
    state, resumed, discarded = loop.run()
    return ResilientResult(output=loop.to_output(state),
                           sscr=float(state["sscr"]),
                           rmse=float(state["rmse"]), resumed_from=resumed,
                           widen_count=loop.widen_count,
                           fallback_steps=discarded,
                           events=loop.tel.events,
                           rebalance_count=loop.rebalance_count)


def _spawned_rank(*args):
    """A spawned rank's body: the runner's own failures come back as
    values (``run()`` has waited for the in-flight save by then)."""
    try:
        return _rank_run(*args)
    except _RANK_FAILURES as e:
        return _RankFailure(e)


def run_resilient_distributed(parts, params, mesh, *,
                              part_axis: str = "part",
                              model_axis: str = "model",
                              plan: EnginePlan | None = None,
                              checkpoint_dir=None,
                              on_overflow: str = "widen",
                              on_corruption: str = "fallback",
                              fault_plan: FaultPlan | None = None,
                              max_retries: int = 3, sleep=None, clock=None,
                              monitor: StragglerMonitor | None = None,
                              rebalance: RebalancePolicy | None = None,
                              sync_saves: bool = False,
                              elastic_resume: bool = False,
                              **legacy) -> ResilientResult:
    """Distributed resilient run over ``mesh`` (a
    :class:`repro_torch.distributed.mesh.Mesh`); see the module
    docstring.

    The stages are the functions of ``build_dsc_stage_programs`` — the
    phase bodies of the monolithic ``run_dsc_distributed`` — and the state
    between them stays on each rank's device (host copies only for rank
    0's checkpoints).  Unlike the monolith's ``on_overflow="widen"``
    (which reruns the phases that read K), the stage-level widen here
    restarts from the checkpointed segment state.

    On a rank of the mesh's process group this runs the loop and returns
    the result (the output on the rank's device).  Anywhere else it
    spawns the ``P * M`` ranks (one ``spawn`` for the whole run) and
    returns rank 0's result, its output on the mesh's device; a failure
    of the runner's own classes is re-raised with its class and message.
    ``sleep``, ``clock`` and ``monitor`` then cross a pickle to the ranks:
    they must be module-level (picklable), and each rank records into its
    own copy of ``monitor``.
    """
    from repro_torch.distributed import mesh as mesh_mod
    plan = resolve_plan(plan, **legacy)
    _check_policies(on_overflow, on_corruption)
    kw = dict(plan=plan, checkpoint_dir=checkpoint_dir,
              on_overflow=on_overflow, on_corruption=on_corruption,
              fault_plan=fault_plan, max_retries=max_retries, sleep=sleep,
              clock=clock, monitor=monitor, rebalance=rebalance,
              sync_saves=sync_saves, elastic_resume=elastic_resume)
    args = (parts, params, mesh, part_axis, model_axis, kw)
    if mesh_mod.comm_for(mesh) is not None:
        return _rank_run(*args)
    res = mesh_mod.spawn(_spawned_rank, mesh, *args)[0]
    if isinstance(res, _RankFailure):
        raise res.exc
    return dataclasses.replace(res, output=mesh_mod.to_device(
        res.output, torch.device("cpu" if mesh.device == "cpu" else "cuda")))
