"""Single-host end-to-end DSC pipeline (Algorithm 1, P = 1) — counterpart
of ``repro.core.dsc``:

    subtrajectory join (Problem 1)  ->  voting  ->  segmentation (Problem 2)
    ->  ST / SP relations  ->  clustering + outliers (Problem 3)

Execution modes (``EnginePlan.mode``):

* ``"materialize"`` — the join cube ``[T, M, C]`` is built on the device
  and read by voting, the TSA2 words and the similarity scatter; the port
  drops it right after the similarity stage (at full size it is 17 GB).
* ``"fused"`` — the cube never exists: the join stage is the fused pass 1
  (K2: vote sums and packed TSA2 words), the similarity stage re-sweeps
  the join after segmentation with the fused pass 2 (K4: the raw
  ``[S, S]`` scatter, or K7: one panel of it at a time).  On CUDA tensors
  they always run their kernels (``use_kernel`` is a materialize-mode
  choice, as in the reference); on the CPU their plain versions.

Similarity representations (``EnginePlan.sim_mode``):

* ``"dense"`` — the ``[S, S]`` matrix;
* ``"topk"`` — per-row top-K neighbor lists streamed panel by panel
  (``similarity.topk_stream``); no ``[S, S]`` tensor exists, clustering
  reads the lists (K8, K9 with the kernel plan) and the scores come from
  the clustering result.  ``DSCOutput.sim`` is ``None``.

Both modes run the same stage bodies under the same ``STAGES`` names, in
``_run_stages`` (the reference's ``_finish`` is folded in so the cube's
only reference can be dropped as soon as nothing reads it), and
``DSCOutput`` carries no ``join``.  ``use_index`` is a later slice of the
port and raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import geometry, segmentation, similarity, voting
from repro_torch.core.clustering import (cluster, rmse, rmse_from_result,
                                         sscr, sscr_from_result)
from repro_torch.core.plan import EnginePlan, resolve_plan
from repro_torch.core.types import (ClusteringResult, DSCParams,
                                    SubtrajSegmentation, SubtrajTable,
                                    TopKSim, TrajectoryBatch)
from repro_torch.kernels.stjoin import ops as stjoin_ops

STAGES = ("join_vote", "segment", "similarity", "cluster", "score")
# the default K of sim_mode="topk" (clamped to S)
DEFAULT_TOPK = 32
_ON_OVERFLOW = ("raise", "widen", "degrade")


@dataclasses.dataclass
class DSCOutput:
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
    """Per-stage times in ms: CUDA events on the card, the host clock on
    the CPU.  Read ``times`` after the run (it synchronizes once)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._marks: list[tuple[str, object, object]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
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
        """ms per stage name, summed over the times a stage ran."""
        if self.cuda:
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for n, s, e in self._marks:
            ms = s.elapsed_time(e) if self.cuda else (e - s) * 1e3
            out[n] = out.get(n, 0.0) + ms
        return out


def _segment_body(batch, params, vote, masks, plan: EnginePlan):
    """Voting signal -> segmentation -> subtrajectory table."""
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
    table = similarity.build_subtraj_table(
        batch, seg, vote, params.max_subtrajs_per_traj)
    return seg, table


def _similarity_body(batch, params, join, seg, table, plan: EnginePlan,
                     k: int):
    """SP relation: ``(sim, topk)``, exactly one of them not None.  From
    the cube or (fused mode, ``join is None``) from the fused pass 2: the
    dense ``[S, S]`` matrix, or (``sim_mode="topk"``) the panel-streamed
    ``[S, K]`` lists."""
    ms = params.max_subtrajs_per_traj
    if plan.sim_mode == "topk":
        if join is not None:
            return None, similarity.similarity_topk(
                join, seg, seg.sub_local, table, ms, k=k,
                panel=plan.sim_panel)
        Sb = similarity.plan_panel(table.num_slots, plan.sim_panel)

        def panel_raw(p0):
            return stjoin_ops.stjoin_sim_panel_fused(
                batch, batch, seg.sub_local, seg.sub_local, ms,
                params.eps_sp, params.eps_t, params.delta_t, p0=p0,
                panel=Sb)

        return None, similarity.topk_stream(panel_raw, table, k=k, panel=Sb)
    if join is None:
        raw = stjoin_ops.stjoin_sim_fused(
            batch, batch, seg.sub_local, seg.sub_local, ms, params.eps_sp,
            params.eps_t, params.delta_t)
        return similarity.finalize_sim(raw, table), None
    return similarity.similarity_matrix(join, seg, seg.sub_local, table,
                                        ms), None


def _cluster_body(simlike, table, params, plan: EnginePlan):
    """Problem 3: ``(result, rounds, overflow)``; ``overflow`` is None on
    the dense path (the certificate exists only for top-K lists)."""
    result, rounds = cluster(simlike, table, params,
                             engine=plan.cluster_engine,
                             use_kernel=plan.cluster_use_kernel,
                             with_rounds=True)
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


def _join_vote_materialize_body(batch, params, plan: EnginePlan):
    if plan.use_kernel:
        join = stjoin_ops.subtrajectory_join(
            batch, batch, params.eps_sp, params.eps_t, params.delta_t)
    else:
        join = geometry.subtrajectory_join(
            batch, batch, params.eps_sp, params.eps_t, params.delta_t)
    vote, masks = _vote_from_join_body(params, join)
    return join, vote, masks


def _join_vote_fused_body(batch, params, plan: EnginePlan):
    """Fused pass 1: ``(None, vote, masks)`` — no cube."""
    vote, masks = stjoin_ops.stjoin_vote_fused_arrays(
        batch.x, batch.y, batch.t, batch.valid, batch.traj_id,
        batch.x, batch.y, batch.t, batch.valid, batch.traj_id,
        params.eps_sp, params.eps_t, params.delta_t,
        with_masks=params.segmentation == "tsa2")
    return None, vote, masks


_JOIN_VOTE = {"materialize": _join_vote_materialize_body,
              "fused": _join_vote_fused_body}


def _run_stages(batch, params, plan: EnginePlan, timer: StageTimer,
                on_overflow: str) -> DSCOutput:
    """The stages in order.  In top-K mode the similarity, cluster and
    score stages run again with K doubled while the certificate fails
    (``on_overflow="widen"``); the join/vote and segmentation stages do
    not read K, so each retry gives what the reference's full re-dispatch
    gives.  The cube's only reference (materialize mode) is dropped once
    nothing can read it again: after the dense similarity stage, or after
    the last top-K dispatch."""
    with timer.stage("join_vote"):
        join, vote, masks = _JOIN_VOTE[plan.mode](batch, params, plan)
    with timer.stage("segment"):
        seg, table = _segment_body(batch, params, vote, masks, plan)
    del masks
    S = table.num_slots
    k = min(plan.sim_topk or DEFAULT_TOPK, S)
    dispatches, total_rounds = 0, 0
    while True:
        with timer.stage("similarity"):
            sim, topk = _similarity_body(batch, params, join, seg, table,
                                         plan, k)
        if topk is None:
            join = None
        with timer.stage("cluster"):
            result, rounds, overflow = _cluster_body(
                sim if topk is None else topk, table, params, plan)
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
    return DSCOutput(vote=vote, seg=seg, table=table, sim=sim,
                     sim_topk=topk, sim_overflow=overflow, result=result,
                     sscr=sscr_v, rmse=rmse_v, rounds=total_rounds,
                     dispatches=dispatches)


def run_dsc(batch: TrajectoryBatch, params: DSCParams, *,
            plan: EnginePlan | None = None, device=None,
            stage_times: dict | None = None,
            on_overflow: str = "widen") -> DSCOutput:
    """Run the full DSC pipeline on one device.

    ``plan`` (``None`` = the default, all-plain plan) picks each stage's
    engine.  ``device`` (``None`` = the card) is where the pipeline runs:
    the batch is moved there if it lies elsewhere, and asking for the card
    where there is none raises.  ``stage_times``, when given, is filled
    with the time of each stage in ms (CUDA events on the card), summed
    over the dispatches.

    ``sim_mode="topk"`` keeps per-row top-K lists instead of the
    ``[S, S]`` matrix, with K = ``plan.sim_topk`` (default 32, clamped to
    S) and panels of at most ``plan.sim_panel`` rows (default 128).
    Labels equal the dense path's whenever the spill certificate holds
    (``out.sim_overflow == 0``).  ``on_overflow`` is the policy when it
    does not: ``"widen"`` runs the similarity, cluster and score stages
    again with K doubled until it holds (at K = S it always does),
    ``"raise"`` raises ``RuntimeError``, ``"degrade"`` returns the
    truncated result with the violations in ``out.sim_overflow``.
    ``out.dispatches`` counts the passes, ``out.sim_topk.k`` is the final K.
    """
    from repro_torch.kernels import resolve_device
    plan = resolve_plan(plan)
    if on_overflow not in _ON_OVERFLOW:
        raise ValueError(f"on_overflow={on_overflow!r}: expected "
                         "'raise', 'widen', or 'degrade'")
    if plan.use_index:
        raise NotImplementedError(
            "use_index (kernels K10-K13) is ROADMAP queue 1 item 8")
    dev = resolve_device(device)
    if batch.device != dev:
        batch = batch.to(dev)
    timer = StageTimer(dev)
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
