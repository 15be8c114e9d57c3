"""Single-host end-to-end DSC pipeline (Algorithm 1, P = 1) — counterpart
of ``repro.core.dsc`` with a dense similarity matrix:

    subtrajectory join (Problem 1)  ->  voting  ->  segmentation (Problem 2)
    ->  ST / SP relations  ->  clustering + outliers (Problem 3)

Execution modes (``EnginePlan.mode``):

* ``"materialize"`` — the join cube ``[T, M, C]`` is built on the device
  and read by voting, the TSA2 words and the similarity scatter; the port
  drops it right after the similarity stage (at full size it is 17 GB).
* ``"fused"`` — the cube never exists: the join stage is the fused pass 1
  (K2: vote sums and packed TSA2 words), the similarity stage re-sweeps
  the join after segmentation with the fused pass 2 (K4: the raw
  ``[S, S]`` scatter).  On CUDA tensors both always run their kernels
  (``use_kernel`` is a materialize-mode choice, as in the reference); on
  the CPU their plain versions.

Both modes run the same stage bodies under the same ``STAGES`` names, in
``_run_stages`` (the reference's ``_finish`` is folded in so the cube's
only reference can be dropped after the similarity stage), and
``DSCOutput`` carries no ``join``.  ``sim_mode="topk"`` and ``use_index``
are later slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import geometry, segmentation, similarity, voting
from repro_torch.core.clustering import cluster, rmse, sscr
from repro_torch.core.plan import EnginePlan, resolve_plan
from repro_torch.core.types import (ClusteringResult, DSCParams,
                                    SubtrajSegmentation, SubtrajTable,
                                    TrajectoryBatch)
from repro_torch.kernels.stjoin import ops as stjoin_ops

STAGES = ("join_vote", "segment", "similarity", "cluster", "score")


@dataclasses.dataclass
class DSCOutput:
    vote: torch.Tensor              # [T, M] point voting
    seg: SubtrajSegmentation
    table: SubtrajTable
    sim: torch.Tensor               # [S, S]
    result: ClusteringResult
    sscr: torch.Tensor              # Eq. 3 objective
    rmse: torch.Tensor              # Sec. 6.2 quality metric
    rounds: int | None              # clustering rounds (None: sequential)


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
        if self.cuda:
            torch.cuda.synchronize()
            return {n: s.elapsed_time(e) for n, s, e in self._marks}
        return {n: (e - s) * 1e3 for n, s, e in self._marks}


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


def _similarity_body(batch, params, join, seg, table):
    """SP relation, dense: the ``[S, S]`` matrix, from the cube or (fused
    mode, ``join is None``) from the fused pass 2."""
    if join is None:
        raw = stjoin_ops.stjoin_sim_fused(
            batch, batch, seg.sub_local, seg.sub_local,
            params.max_subtrajs_per_traj, params.eps_sp, params.eps_t,
            params.delta_t)
        return similarity.finalize_sim(raw, table)
    return similarity.similarity_matrix(
        join, seg, seg.sub_local, table, params.max_subtrajs_per_traj)


def _cluster_body(sim, table, params, plan: EnginePlan):
    """Problem 3: ``(result, rounds)``."""
    return cluster(sim, table, params, engine=plan.cluster_engine,
                   use_kernel=plan.cluster_use_kernel, with_rounds=True)


def _score_body(result, sim, params):
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


def _run_stages(batch, params, plan: EnginePlan,
                timer: StageTimer) -> DSCOutput:
    """The stages in order; the cube's only reference (materialize mode)
    is dropped after the similarity stage, before clustering."""
    with timer.stage("join_vote"):
        join, vote, masks = _JOIN_VOTE[plan.mode](batch, params, plan)
    with timer.stage("segment"):
        seg, table = _segment_body(batch, params, vote, masks, plan)
    del masks
    with timer.stage("similarity"):
        sim = _similarity_body(batch, params, join, seg, table)
    del join
    with timer.stage("cluster"):
        result, rounds = _cluster_body(sim, table, params, plan)
    with timer.stage("score"):
        sscr_v, rmse_v = _score_body(result, sim, params)
    return DSCOutput(vote=vote, seg=seg, table=table, sim=sim, result=result,
                     sscr=sscr_v, rmse=rmse_v, rounds=rounds)


def run_dsc(batch: TrajectoryBatch, params: DSCParams, *,
            plan: EnginePlan | None = None, device=None,
            stage_times: dict | None = None) -> DSCOutput:
    """Run the full DSC pipeline on one device.

    ``plan`` (``None`` = the default, all-plain plan) picks each stage's
    engine.  ``device`` (``None`` = the card) is where the pipeline runs:
    the batch is moved there if it lies elsewhere, and asking for the card
    where there is none raises.  ``stage_times``, when given, is filled
    with the time of each stage in ms (CUDA events on the card).
    """
    from repro_torch.kernels import resolve_device
    plan = resolve_plan(plan)
    if plan.sim_mode != "dense":
        raise NotImplementedError(
            "sim_mode='topk' (kernels K7-K9) is ROADMAP queue 1 item 7")
    if plan.use_index:
        raise NotImplementedError(
            "use_index (kernels K10-K13) is ROADMAP queue 1 item 8")
    dev = resolve_device(device)
    if batch.device != dev:
        batch = batch.to(dev)
    timer = StageTimer(dev)
    out = _run_stages(batch, params, plan, timer)
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
