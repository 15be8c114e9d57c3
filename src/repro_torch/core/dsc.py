"""Single-host end-to-end DSC pipeline (Algorithm 1, P = 1) — counterpart
of ``repro.core.dsc``:

    subtrajectory join (Problem 1)  ->  voting  ->  segmentation (Problem 2)
    ->  ST / SP relations  ->  clustering + outliers (Problem 3)

Execution modes (``EnginePlan.mode``):

* ``"materialize"`` — the join cube ``[T, M, C]`` is built on the device
  and read by voting, the TSA2 words and the similarity scatter, and
  returned in ``DSCOutput.join`` (at full size it is 17 GB).
* ``"fused"`` — the cube never exists (``DSCOutput.join is None``): the
  join stage is the fused pass 1 (K2: vote sums and packed TSA2 words),
  the similarity stage re-sweeps the join after segmentation with the
  fused pass 2 (K4: the raw ``[S, S]`` scatter, or K7: one panel of it
  at a time).  On CUDA tensors they always run their kernels
  (``use_kernel`` is a materialize-mode choice, as in the reference); on
  the CPU their plain versions.

Similarity representations (``EnginePlan.sim_mode``):

* ``"dense"`` — the ``[S, S]`` matrix;
* ``"topk"`` — per-row top-K neighbor lists streamed panel by panel
  (``similarity.topk_stream``); no ``[S, S]`` tensor exists, clustering
  reads the lists (K8, K9 with the kernel plan) and the scores come from
  the clustering result.  ``DSCOutput.sim`` is ``None``.

Both modes run the same stage bodies under the same ``STAGES`` names, in
``_run_stages`` (the reference's ``_finish`` folded in).  The per-stage
entry points (``run_stage_join`` ... ``run_stage_score``) call those same
bodies, so stage k's outputs fed into stage k + 1 give a straight-through
run's outputs bit for bit (the resilient runner's argument).  Each runs
where its inputs lie and keeps no reference to them (the reference
donates some of them; torch has no donation).  ``run_dsc_lowerable`` is
the one-dispatch pipeline: no index planning, no widen loop.

``EnginePlan.use_index`` prunes candidate tiles with the spatiotemporal
grid (``repro_torch.index``), losslessly: materialize mode with the
kernel plan runs the pruned join K10, without it the plain join under the
row-level prune mask; fused mode plans the tiles once
(``plan_fused_tile_ids``, inside the ``join_vote`` stage) and runs the
pruned passes K11 and K12, or K13 per panel, with that one plan in every
dispatch.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import geometry, segmentation, similarity, voting
from repro_torch.core.clustering import (_no_span, cluster, rmse,
                                         rmse_from_result, sscr,
                                         sscr_from_result)
from repro_torch.core.plan import EnginePlan, resolve_plan
from repro_torch.core.types import (ClusteringResult, DSCParams,
                                    JoinResult, SubtrajSegmentation,
                                    SubtrajTable, TopKSim, TrajectoryBatch)
from repro_torch.kernels.stjoin import ops as stjoin_ops

STAGES = ("join_vote", "segment", "similarity", "cluster", "score")
# the default K of sim_mode="topk" (clamped to S)
DEFAULT_TOPK = 32
_ON_OVERFLOW = ("raise", "widen", "degrade")


@dataclasses.dataclass
class DSCOutput:
    join: JoinResult | None         # [T, M, C] cube; None in fused mode
    vote: torch.Tensor              # [T, M] point voting
    seg: SubtrajSegmentation
    table: SubtrajTable
    sim: torch.Tensor | None        # [S, S]; None in sim_mode="topk"
    sim_topk: TopKSim | None        # [S, K] lists in sim_mode="topk"
    sim_overflow: torch.Tensor | None  # [] i32 certificate violations (topk)
    result: ClusteringResult
    sscr: torch.Tensor              # Eq. 3 objective
    rmse: torch.Tensor              # Sec. 6.2 quality metric
    rounds: int | None              # clustering rounds summed over the
                                    # dispatches (None: sequential)
    dispatches: int = 1             # similarity/cluster/score passes (the
                                    # top-K widen loop may run several)


class StageTimer:
    """The spans of one DSC run: each stage (``STAGES``) and each part of
    one, named ``<stage>.<part>`` and nested inside its stage.  With
    ``record`` a span is timed (CUDA events on the card, the host clock on
    the CPU); while a ``torch.profiler`` session records (asked once, when
    the timer is made) it also opens a ``record_function`` range of its
    name, on the clock of the device's kernels.  With neither it records
    nothing.  Read ``times`` after the run (it synchronizes once)."""

    def __init__(self, device: torch.device, record: bool = True):
        self.cuda = device.type == "cuda"
        self.record = record
        self.annotate = torch.autograd._profiler_enabled()
        self._marks: list[tuple[str, object, object]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        rng = (torch.profiler.record_function(name) if self.annotate
               else contextlib.nullcontext())
        with rng:
            if not self.record:
                yield
                return
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
            else:
                start = time.perf_counter()
                yield
                end = time.perf_counter()
            self._marks.append((name, start, end))

    @property
    def times(self) -> dict[str, float]:
        """ms per span name, summed over the times a span ran."""
        if self.cuda and self._marks:
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for n, s, e in self._marks:
            ms = s.elapsed_time(e) if self.cuda else (e - s) * 1e3
            out[n] = out.get(n, 0.0) + ms
        return out


def _segment_body(batch, params, vote, masks, plan: EnginePlan,
                  span=_no_span):
    """Voting signal -> segmentation -> subtrajectory table (the part
    ``segment.table``)."""
    nvote = voting.normalized_voting(vote, batch.valid)
    if params.segmentation == "tsa1":
        seg = segmentation.tsa1(nvote, batch.valid, params.w, params.tau,
                                params.max_subtrajs_per_traj)
    elif params.segmentation == "tsa2":
        seg = segmentation.tsa2(masks, batch.valid, params.w, params.tau,
                                params.max_subtrajs_per_traj,
                                use_kernel=plan.seg_use_kernel)
    else:
        raise ValueError(f"unknown segmentation {params.segmentation!r}")
    with span("segment.table"):
        table = similarity.build_subtraj_table(
            batch, seg, vote, params.max_subtrajs_per_traj)
    return seg, table


def _similarity_body(batch, params, join, seg, table, plan: EnginePlan,
                     k: int, tiles=None, span=_no_span):
    """SP relation: ``(sim, topk)``, exactly one of them not None.  From
    the cube or (fused mode, ``join is None``) from the fused pass 2 over
    the tile plan ``tiles`` (``None``: every tile): the dense ``[S, S]``
    matrix, its Eq. 2 normalization the part ``similarity.finalize``, or
    (``sim_mode="topk"``) the panel-streamed ``[S, K]`` lists."""
    ms = params.max_subtrajs_per_traj
    if plan.sim_mode == "topk":
        if join is not None:
            return None, similarity.similarity_topk(
                join, seg, seg.sub_local, table, ms, k=k,
                panel=plan.sim_panel, use_kernel=plan.cluster_use_kernel)
        Sb = similarity.plan_panel(table.num_slots, plan.sim_panel)
        # operands, slot-map check and chunk time bounds once per dispatch
        sweep = stjoin_ops.sim_panel_sweep(
            batch, batch, seg.sub_local, seg.sub_local, ms, params.eps_sp,
            params.eps_t, params.delta_t, tile_ids=tiles)
        return None, similarity.topk_stream(
            lambda p0: sweep(p0, panel=Sb), table, k=k, panel=Sb,
            use_kernel=plan.cluster_use_kernel)
    if join is None:
        raw = stjoin_ops.stjoin_sim_fused(
            batch, batch, seg.sub_local, seg.sub_local, ms, params.eps_sp,
            params.eps_t, params.delta_t, tile_ids=tiles)
    else:
        raw = similarity.similarity_scatter(join, seg, seg.sub_local,
                                            table, ms)
    with span("similarity.finalize"):
        return similarity.finalize_sim(raw, table), None


def _cluster_body(simlike, table, params, plan: EnginePlan, span):
    """Problem 3: ``(result, rounds, overflow)``; ``overflow`` is None on
    the dense path (the certificate exists only for top-K lists)."""
    result, rounds = cluster(simlike, table, params,
                             engine=plan.cluster_engine,
                             use_kernel=plan.cluster_use_kernel,
                             with_rounds=True, tiles=plan.cluster_tiles,
                             span=span)
    if isinstance(simlike, TopKSim):
        return result, rounds, similarity.topk_overflow(simlike,
                                                        result.alpha_used)
    return result, rounds, None


def _score_body(result, sim, params):
    """Quality metrics: from the result alone when there is no matrix."""
    if sim is None:
        return sscr_from_result(result), rmse_from_result(result,
                                                          params.eps_sp)
    return sscr(result, sim), rmse(result, sim, params.eps_sp)


def _vote_from_join_body(params, join):
    vote = voting.point_voting(join)
    masks = (voting.neighbor_mask_packed(join)
             if params.segmentation == "tsa2" else None)
    return vote, masks


def plan_fused_tile_ids(batch: TrajectoryBatch, params: DSCParams,
                        plan: EnginePlan):
    """Host-side fused-tile planning (``mode="fused"`` + ``use_index``):
    ``(tiles, plan)``, ``tiles`` the ``FusedTilePlan`` of the batch's
    self-join in the port's geometry, or ``None`` when the index is off.
    The plan comes back unchanged: the reference binds the tile plan's
    TPU geometry into it, and the CUDA kernels take none.  The tiles
    depend only on the batch and the eps thresholds, so one tile plan
    serves every dispatch."""
    if not (plan.mode == "fused" and plan.use_index):
        return None, plan
    return stjoin_ops.plan_fused_tiles(
        batch.x, batch.y, batch.t, batch.valid,
        batch.x, batch.y, batch.t, batch.valid, params.eps_sp,
        params.eps_t), plan


def _join_vote_materialize_body(batch, params, plan: EnginePlan):
    """``(join, vote, masks)``: the cube, from K1, K10 (``use_index`` with
    the kernel plan) or the plain join (pruned by the row-level mask under
    ``use_index``)."""
    if plan.use_kernel:
        join = stjoin_ops.subtrajectory_join(
            batch, batch, params.eps_sp, params.eps_t, params.delta_t,
            use_index=plan.use_index)
    else:
        join = geometry.subtrajectory_join(
            batch, batch, params.eps_sp, params.eps_t, params.delta_t,
            use_index=plan.use_index)
    vote, masks = _vote_from_join_body(params, join)
    return join, vote, masks


def _join_vote_fused_body(batch, params, tiles, plan: EnginePlan):
    """Fused pass 1 over the tile plan ``tiles`` (``None``: every tile):
    ``(vote, masks)`` — no cube."""
    return stjoin_ops.stjoin_vote_fused_arrays(
        batch.x, batch.y, batch.t, batch.valid, batch.traj_id,
        batch.x, batch.y, batch.t, batch.valid, batch.traj_id,
        params.eps_sp, params.eps_t, params.delta_t, tile_ids=tiles,
        with_masks=params.segmentation == "tsa2")


def _topk_k(plan: EnginePlan, S: int) -> int:
    """K of a dispatch: ``plan.sim_topk`` (default 32), clamped to S."""
    return min(plan.sim_topk or DEFAULT_TOPK, S)


def _run_stages(batch, params, plan: EnginePlan, timer: StageTimer,
                on_overflow: str) -> DSCOutput:
    """The stages in order.  In top-K mode the similarity, cluster and
    score stages run again with K doubled while the certificate fails
    (``on_overflow="widen"``); the join/vote and segmentation stages do
    not read K, so each retry gives what the reference's full re-dispatch
    gives.  The cube (materialize mode) is returned with the output."""
    with timer.stage("join_vote"):
        if plan.mode == "fused":
            tiles, plan = plan_fused_tile_ids(batch, params, plan)
            join = None
            vote, masks = _join_vote_fused_body(batch, params, tiles, plan)
        else:
            tiles = None
            join, vote, masks = _join_vote_materialize_body(batch, params,
                                                            plan)
    with timer.stage("segment"):
        seg, table = _segment_body(batch, params, vote, masks, plan,
                                   timer.stage)
    del masks
    S = table.num_slots
    k = _topk_k(plan, S)
    dispatches, total_rounds = 0, 0
    while True:
        with timer.stage("similarity"):
            sim, topk = _similarity_body(batch, params, join, seg, table,
                                         plan, k, tiles, timer.stage)
        with timer.stage("cluster"):
            result, rounds, overflow = _cluster_body(
                sim if topk is None else topk, table, params, plan,
                timer.stage)
        with timer.stage("score"):
            sscr_v, rmse_v = _score_body(result, sim, params)
        dispatches += 1
        total_rounds = None if rounds is None else total_rounds + rounds
        n_over = 0 if overflow is None else int(overflow)
        if n_over == 0 or on_overflow == "degrade":
            break
        if k >= S:                  # unreachable: K == S cannot spill
            raise AssertionError("overflow with K == S")
        if on_overflow == "raise":
            raise RuntimeError(
                f"sim_topk={k} truncated a potential alpha-edge on "
                f"{n_over} rows (spill >= alpha): labels would not be "
                "exact.  Raise sim_topk or enable sim_topk_retry.")
        k = min(2 * k, S)
        del topk, result
    return DSCOutput(join=join, vote=vote, seg=seg, table=table, sim=sim,
                     sim_topk=topk, sim_overflow=overflow, result=result,
                     sscr=sscr_v, rmse=rmse_v, rounds=total_rounds,
                     dispatches=dispatches)


# --------------------------------------------------------------------------
# Per-stage entry points — the checkpointable boundaries of a resilient
# runner.  Each calls the body that ``_run_stages`` runs for its stage.
# --------------------------------------------------------------------------


def run_stage_join(batch: TrajectoryBatch, params: DSCParams,
                   plan: EnginePlan):
    """Materialize-mode stage 1: ``(join, vote, masks)`` (``masks`` None
    under TSA1)."""
    return _join_vote_materialize_body(batch, params, plan)


def run_stage_join_fused(batch: TrajectoryBatch, params: DSCParams,
                         tile_ids, plan: EnginePlan):
    """Fused-mode stage 1 over the tile plan ``tile_ids`` (the first item
    of ``plan_fused_tile_ids``): ``(vote, masks)`` — the cube never
    exists."""
    return _join_vote_fused_body(batch, params, tile_ids, plan)


def run_stage_vote_from_join(batch: TrajectoryBatch, params: DSCParams,
                             join: JoinResult, plan: EnginePlan):
    """Stage 1 tail for a join made outside the stage: ``(vote, masks)``."""
    return _vote_from_join_body(params, join)


def run_stage_segment(batch: TrajectoryBatch, params: DSCParams, vote,
                      masks, plan: EnginePlan):
    """Stage 2: ``(seg, table)`` from the vote state."""
    return _segment_body(batch, params, vote, masks, plan)


def run_stage_similarity(batch: TrajectoryBatch, params: DSCParams, join,
                         seg: SubtrajSegmentation, table: SubtrajTable,
                         tile_ids, plan: EnginePlan):
    """Stage 3: the SP relation, ``(sim, topk)``, exactly one not None;
    from ``join`` (materialize) or the fused pass 2 over ``tile_ids``
    (``join is None``).  K is ``plan.sim_topk`` (default 32), clamped to
    S."""
    return _similarity_body(batch, params, join, seg, table, plan,
                            _topk_k(plan, table.num_slots), tile_ids)


def run_stage_cluster(simlike, table: SubtrajTable, params: DSCParams,
                      plan: EnginePlan):
    """Stage 4: clustering of the dense matrix or the ``TopKSim``,
    ``(result, overflow)``; ``overflow`` is None on the dense path."""
    result, _, overflow = _cluster_body(simlike, table, params, plan,
                                        _no_span)
    return result, overflow


def run_stage_score(result: ClusteringResult, sim, params: DSCParams):
    """Stage 5: ``(sscr, rmse)`` (from the result alone when ``sim`` is
    None)."""
    return _score_body(result, sim, params)


def run_dsc_lowerable(batch: TrajectoryBatch, params: DSCParams,
                      plan: EnginePlan, *, device=None) -> DSCOutput:
    """The pipeline in one dispatch: no index planning and no widen loop.
    K is clamped to S up front and the top-K certificate is returned in
    ``out.sim_overflow``, not acted on; ``use_index=True`` is refused.
    The reference's autotuner times this surface, one plan at a time;
    ``device`` as in :func:`run_dsc`."""
    plan = resolve_plan(plan)
    if plan.use_index:
        raise ValueError("run_dsc_lowerable requires use_index=False "
                         "(index planning is host-driven); use run_dsc")
    batch = _on_device(batch, device)
    S = batch.num_trajs * params.max_subtrajs_per_traj
    plan = plan.replace(sim_topk=_topk_k(plan, S))
    return _run_stages(batch, params, plan,
                       StageTimer(batch.device, record=False), "degrade")


def _on_device(batch: TrajectoryBatch, device) -> TrajectoryBatch:
    """``batch`` on ``device`` (``None`` = the card, which must exist)."""
    from repro_torch.kernels import resolve_device
    dev = resolve_device(device)
    return batch if batch.device == dev else batch.to(dev)


def run_dsc(batch: TrajectoryBatch, params: DSCParams,
            use_kernel: bool = False, *, use_index: bool = False,
            mode: str = "materialize",
            fused_tiles: tuple[int, int, int] | None = None,
            cluster_engine: str = "rounds",
            cluster_use_kernel: bool = False,
            seg_use_kernel: bool = False,
            sim_mode: str = "dense",
            sim_topk: int | None = None,
            sim_panel: int | None = None,
            sim_topk_retry: bool = True,
            on_overflow: str | None = None,
            plan: EnginePlan | None = None, device=None,
            stage_times: dict | None = None) -> DSCOutput:
    """Run the full DSC pipeline on one device.

    ``plan`` (``None`` = the default, all-plain plan) picks each stage's
    engine.  The per-stage flags (``use_kernel`` ... ``sim_panel``) are
    the reference's deprecated aliases: they materialize a plan through
    ``resolve_plan``, and a plan together with a flag at a non-default
    value raises.  ``device`` (``None`` = the card) is where the pipeline runs:
    the batch is moved there if it lies elsewhere, and asking for the card
    where there is none raises.  ``stage_times``, when given, is filled
    with the time of each span in ms (CUDA events on the card), summed
    over the dispatches: the stages by their ``STAGES`` names, and the
    parts that the plan runs inside them: ``segment.table`` (the slot
    table), ``similarity.finalize`` (the dense matrix's normalization)
    and the rounds engines' ``cluster.thresholds`` and
    ``cluster.round_loop``.  While a ``torch.profiler`` session records,
    each span is also a ``record_function`` range of its name; with
    neither, the spans record nothing.

    ``sim_mode="topk"`` keeps per-row top-K lists instead of the
    ``[S, S]`` matrix, with K = ``plan.sim_topk`` (default 32, clamped to
    S) and panels of at most ``plan.sim_panel`` rows (default 128).
    Labels equal the dense path's whenever the spill certificate holds
    (``out.sim_overflow == 0``).  ``on_overflow`` is the policy when it
    does not: ``"widen"`` runs the similarity, cluster and score stages
    again with K doubled until it holds (at K = S it always does),
    ``"raise"`` raises ``RuntimeError``, ``"degrade"`` returns the
    truncated result with the violations in ``out.sim_overflow``.  The
    default (``None``) is the deprecated ``sim_topk_retry``'s policy:
    ``"widen"`` when it is true, ``"raise"`` otherwise; passing both
    raises.  ``out.dispatches`` counts the passes, ``out.sim_topk.k`` is
    the final K.
    """
    plan = resolve_plan(plan, mode=mode, use_kernel=use_kernel,
                        use_index=use_index, fused_tiles=fused_tiles,
                        cluster_engine=cluster_engine,
                        cluster_use_kernel=cluster_use_kernel,
                        seg_use_kernel=seg_use_kernel, sim_mode=sim_mode,
                        sim_topk=sim_topk, sim_panel=sim_panel)
    if on_overflow is not None:
        if on_overflow not in _ON_OVERFLOW:
            raise ValueError(f"on_overflow={on_overflow!r}: expected "
                             "'raise', 'widen', or 'degrade'")
        if not sim_topk_retry:
            raise ValueError("pass either on_overflow or "
                             "sim_topk_retry=False, not both")
    else:
        on_overflow = "widen" if sim_topk_retry else "raise"
    batch = _on_device(batch, device)
    timer = StageTimer(batch.device, record=stage_times is not None)
    out = _run_stages(batch, params, plan, timer, on_overflow)
    if stage_times is not None:
        stage_times.update(timer.times)
    return out


def cluster_summary(out: DSCOutput) -> dict:
    """Host-side summary: cluster -> member subtraj slots; outliers list."""
    member_of = out.result.member_of.cpu().numpy()
    is_rep = out.result.is_rep.cpu().numpy()
    is_out = out.result.is_outlier.cpu().numpy()
    valid = out.table.valid.cpu().numpy()
    owner = np.where(is_rep, np.arange(member_of.shape[0]), member_of)
    slots = np.nonzero(valid & (is_rep | (member_of >= 0)))[0]
    by_owner = slots[np.argsort(owner[slots], kind="stable")]
    reps, starts = np.unique(owner[by_owner], return_index=True)
    clusters = {int(rep): members.tolist()
                for rep, members in zip(reps, np.split(by_owner, starts[1:]))}
    return {
        "clusters": clusters,
        "outliers": [int(s) for s in np.nonzero(valid & is_out)[0]],
        "num_clusters": len(clusters),
        "sscr": float(out.sscr),
        "rmse": float(out.rmse),
        "alpha": float(out.result.alpha_used),
        "k": float(out.result.k_used),
    }
