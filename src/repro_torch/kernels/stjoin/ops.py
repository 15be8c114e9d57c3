"""Public wrappers: TrajectoryBatch- and array-level subtrajectory join
through the join kernels (counterpart of ``repro.kernels.stjoin.ops``:
the dense ``best_match_join_kernel`` and ``subtrajectory_join``, the
fused streaming passes ``stjoin_vote_fused(_arrays)``,
``stjoin_sim_fused(_arrays)`` and ``stjoin_sim_panel_fused(_arrays)``, and
their index-pruned variants: ``plan_join_index`` /
``best_match_join_pruned`` and ``plan_fused_tiles`` with the ``tile_ids=``
plans of the fused passes).

Dispatch is on the tensors' device: CUDA tensors launch the CUDA kernels
(``csrc/dsc_kernels.cu``: ``stjoin_best_match``, ``stjoin_vote_fused``,
``stjoin_sim_fused``, ``stjoin_sim_panel_fused`` and their ``*_pruned``
twins K10-K13), CPU tensors take the plain versions in ``ref.py``.
The dense kernels need no padding and no tile geometry: the TPU's
row-aligned blocks and word-aligned candidate blocks are a tiling
constraint of the Pallas kernels, not part of the contract.  A tile plan
is part of the contract: its ids address candidate blocks, so a plan is
bound to its geometry.  The plan functions take the geometry as
arguments, as the reference's do, and default to the port's own CUDA
blocks (``JOIN_BP x JOIN_BC`` for the join, ``FUSED_ROWS x FUSED_BC`` for
the fused passes); the pruned kernels accept only those, the plain
versions any.  Numerics are set out in this package's docstring.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.geometry import filter_delta_t
from repro_torch.core.similarity import slot_ids
from repro_torch.core.types import JoinResult, TrajectoryBatch, f32
from repro_torch.index import grid as gridx
from repro_torch.kernels import check_cuda_operands, launch
from repro_torch.kernels.stjoin.ref import (stjoin_pruned_ref, stjoin_ref,
                                            stjoin_sim_fused_ref,
                                            stjoin_sim_panel_fused_ref,
                                            stjoin_vote_fused_ref)

# shared memory an sm_90 block can opt into, less the sweep's static
# candidate staging (the K2 / K4 row tiles are dynamic shared memory)
_DYN_SMEM_MAX = 232448 - 13728
# the port's tile geometry: K1's block of 64 reference points x 32
# candidates (K10), and the block of K2, K4 and K7, one reference row x
# 32 candidates (K11-K13; a candidate tile is then one packed TSA2 word)
JOIN_BP, JOIN_BC = 64, 32
FUSED_ROWS, FUSED_BC = 1, 32


def _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct, cvalid, cid):
    """Kernel operand order: ref x, y, t, id, ok flattened to ``[T*M]``
    (the id repeated per point), then cand x, y, t, id, ok."""
    T, M = rx.shape
    flat = lambda a: a.contiguous().view(-1)
    rid_p = rid.to(torch.int32)[:, None].expand(T, M)
    return ((flat(rx), flat(ry), flat(rt), flat(rid_p), flat(rvalid)),
            (cx.contiguous(), cy.contiguous(), ct.contiguous(),
             cid.to(torch.int32).contiguous(), cvalid.contiguous()))


def _eps(*v):
    return tuple(float(f32(x, "cpu")) for x in v)


def stjoin_best_match(ref_x, ref_y, ref_t, ref_id, ref_ok,
                      cand_x, cand_y, cand_t, cand_id, cand_ok, eps_sp,
                      eps_t, *, out_w=None, out_idx=None):
    """``(best_w [P, C] f32, best_idx [P, C] i32)`` — the K1 contract.

    ``out_w`` / ``out_idx`` may name ``[P, C]`` views to write into.
    """
    if not ref_x.is_cuda:
        w, idx = stjoin_ref(ref_x, ref_y, ref_t, ref_id, ref_ok, cand_x,
                            cand_y, cand_t, cand_id, cand_ok, eps_sp, eps_t)
        if out_w is not None:
            out_w.copy_(w)
            out_idx.copy_(idx)
            return out_w, out_idx
        return w, idx
    P = ref_x.shape[0]
    C, Mc = cand_x.shape
    f, i, b = torch.float32, torch.int32, torch.bool
    dev = check_cuda_operands(
        "stjoin_best_match", ref_x=(ref_x, f), ref_y=(ref_y, f),
        ref_t=(ref_t, f), ref_id=(ref_id, i), ref_ok=(ref_ok, b),
        cand_x=(cand_x, f), cand_y=(cand_y, f), cand_t=(cand_t, f),
        cand_id=(cand_id, i), cand_ok=(cand_ok, b))
    if out_w is None:
        out_w = torch.empty((P, C), dtype=f, device=dev)
        out_idx = torch.empty((P, C), dtype=i, device=dev)
    check_cuda_operands("stjoin_best_match", ref_x=(ref_x, f),
                        out_w=(out_w, f), out_idx=(out_idx, i))
    if out_w.shape != (P, C) or out_idx.shape != (P, C):
        raise ValueError("stjoin_best_match: outputs must be [P, C]")
    ops = (ref_x, ref_y, ref_t, ref_id, ref_ok, cand_x, cand_y, cand_t,
           cand_id, cand_ok)
    launch("stjoin_best_match", *(t.data_ptr() for t in ops), P, C, Mc,
           *_eps(eps_sp, eps_t), out_w.data_ptr(), out_idx.data_ptr(),
           device=dev)
    return out_w, out_idx


def best_match_join_kernel(ref: TrajectoryBatch, cand: TrajectoryBatch,
                           eps_sp, eps_t) -> JoinResult:
    """Dense best-match join through K1: ``JoinResult [T, M, C]``."""
    T, M = ref.x.shape
    C = cand.x.shape[0]
    best_w = torch.empty((T, M, C), dtype=torch.float32, device=ref.device)
    best_idx = torch.empty((T, M, C), dtype=torch.int32, device=ref.device)
    ref_ops, cand_ops = _flat_operands(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id, cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id)
    stjoin_best_match(*ref_ops, *cand_ops, eps_sp, eps_t,
                      out_w=best_w.view(T * M, C),
                      out_idx=best_idx.view(T * M, C))
    return JoinResult(best_w=best_w, best_idx=best_idx)


# ---------------------------------------------------------------------------
# Index-pruned join: a grid over tile bounding boxes (``repro_torch.index``)
# lists, per reference block, the candidate tiles that can hold a match;
# K10 sweeps only those.  Bit-identical to the dense join.
# ---------------------------------------------------------------------------


def _pad_rows(a: torch.Tensor, mult: int, fill) -> torch.Tensor:
    pad = (-a.shape[0]) % mult
    if pad == 0:
        return a
    return torch.cat([a, a.new_full((pad, *a.shape[1:]), fill)])


def _tile_mask(rboxes, cboxes, eps_sp, eps_t):
    """``(mask [nRb, nCb], counts [nRb] i32, spec)``: the coarse cell test
    on a grid fitted to the candidate tiles, refined by the exact test."""
    spec = gridx.fit_grid(cboxes, float(eps_sp), float(eps_t))
    table = gridx.build_cell_table(spec, cboxes)
    mask = gridx.candidate_tile_mask(spec, table, rboxes, cboxes, eps_sp,
                                     eps_t)
    return mask, mask.sum(dim=1).to(torch.int32), spec


def _compact(mask, counts, max_tiles: int | None, what: str):
    """Tile lists of static width K (``max_tiles`` or the widest list,
    >= 1); raises if K would drop a survivor."""
    need = gridx.plan_max_tiles(counts)
    K = max(max_tiles, 1) if max_tiles is not None else need
    if counts.numel() and int(counts.max()) > K:
        raise ValueError(
            f"max_tiles={K} drops candidate tiles (need {need}); the "
            f"{what} would no longer match the dense one")
    tile_ids, _ = gridx.compact_candidates(mask, K)
    return tile_ids


def plan_join_index(ref: TrajectoryBatch, cand: TrajectoryBatch, eps_sp,
                    eps_t, *, bp: int = JOIN_BP, bc: int = JOIN_BC):
    """Candidate-tile mask of the join, host-driven (the grid is fitted
    from the data): ``(mask [nRb, nCb] bool, counts [nRb] i32, spec)`` for
    blocks of ``bp`` flattened reference points and tiles of ``bc``
    candidate trajectories (both padded with invalid points)."""
    flat = lambda a, f: _pad_rows(a.reshape(-1), bp, f)
    rboxes = gridx.point_block_boxes(flat(ref.x, 0.0), flat(ref.y, 0.0),
                                     flat(ref.t, 0.0), flat(ref.valid, False),
                                     bp)
    pad = lambda a, f: _pad_rows(a, bc, f)
    cboxes = gridx.traj_block_boxes(pad(cand.x, 0.0), pad(cand.y, 0.0),
                                    pad(cand.t, 0.0), pad(cand.valid, False),
                                    bc)
    return _tile_mask(rboxes, cboxes, eps_sp, eps_t)


def _geometry_error(name: str, got, want) -> ValueError:
    fmt = lambda g: ", ".join(f"{k}={v}" for k, v in g.items())
    return ValueError(
        f"{name}: the tile plan was built for {fmt(got)}, but the CUDA "
        f"kernel sweeps blocks of {fmt(want)}; candidate tiles would be "
        "mis-addressed")


def _check_join_geometry(name: str, bp: int, bc: int) -> None:
    if (bp, bc) != (JOIN_BP, JOIN_BC):
        raise _geometry_error(name, dict(bp=bp, bc=bc),
                              dict(bp=JOIN_BP, bc=JOIN_BC))


def _live_pairs(tile_ids: torch.Tensor, by_tile: bool = False):
    """The live entries of a plan as ``(pairs [n, 2] int32 (block, tile)
    on the plan's device, keys [n] on the host)``: row-major with
    ``keys`` the blocks, or (``by_tile``) tile-major with ``keys`` the
    tiles."""
    blk, slot = torch.nonzero(tile_ids >= 0, as_tuple=True)
    tile = tile_ids[blk, slot].long()
    if by_tile:
        order = torch.argsort(tile * tile_ids.shape[0] + blk)
        blk, tile = blk[order], tile[order]
    pairs = torch.stack([blk, tile], dim=1).to(torch.int32).contiguous()
    return pairs, (tile if by_tile else blk).cpu().numpy()


def _id_range(tile_ids: torch.Tensor) -> tuple[int, int]:
    return int(tile_ids.min()), int(tile_ids.max())


def _check_tile_ids(name: str, tile_ids, n_blocks: int, n_tiles: int, dev,
                    id_range=None):
    """A plan the kernels can read: ``[n_blocks, K >= 1]`` int32 on the
    operands' card, every id in ``[-1, n_tiles)`` (``id_range``: the ids'
    (min, max) when known)."""
    check_cuda_operands(name, tile_ids=(tile_ids, torch.int32))
    if tile_ids.device != dev:
        raise ValueError(f"{name}: tile_ids on {tile_ids.device}, the "
                         f"operands on {dev}")
    if tile_ids.dim() != 2 or tile_ids.shape[0] != n_blocks \
            or tile_ids.shape[1] < 1:
        raise ValueError(f"{name}: tile_ids {tuple(tile_ids.shape)}, "
                         f"expected [{n_blocks}, K >= 1]")
    lo, hi = _id_range(tile_ids) if id_range is None else id_range
    if lo < -1 or hi >= n_tiles:
        raise ValueError(f"{name}: a tile id lies outside [-1, {n_tiles})")


def stjoin_best_match_pruned(ref_x, ref_y, ref_t, ref_id, ref_ok,
                             cand_x, cand_y, cand_t, cand_id, cand_ok,
                             tile_ids, eps_sp, eps_t, *, bp: int = JOIN_BP,
                             bc: int = JOIN_BC, out_w=None, out_idx=None):
    """K10: ``(best_w [P, C] f32, best_idx [P, C] i32)`` of K1 over the
    (block of ``bp`` points, tile of ``bc`` candidates) pairs that
    ``tile_ids [ceil(P / bp), K]`` names; ``(0, -1)`` elsewhere."""
    if not ref_x.is_cuda:
        w, idx = stjoin_pruned_ref(ref_x, ref_y, ref_t, ref_id, ref_ok,
                                   cand_x, cand_y, cand_t, cand_id, cand_ok,
                                   tile_ids, eps_sp, eps_t, bp=bp, bc=bc)
        if out_w is not None:
            out_w.copy_(w)
            out_idx.copy_(idx)
            return out_w, out_idx
        return w, idx
    name = "stjoin_best_match_pruned"
    _check_join_geometry(name, bp, bc)
    P = ref_x.shape[0]
    C, Mc = cand_x.shape
    f, i, b = torch.float32, torch.int32, torch.bool
    dev = check_cuda_operands(
        name, ref_x=(ref_x, f), ref_y=(ref_y, f), ref_t=(ref_t, f),
        ref_id=(ref_id, i), ref_ok=(ref_ok, b), cand_x=(cand_x, f),
        cand_y=(cand_y, f), cand_t=(cand_t, f), cand_id=(cand_id, i),
        cand_ok=(cand_ok, b))
    _check_tile_ids(name, tile_ids, -(-P // bp), -(-C // bc), dev)
    if out_w is None:
        out_w = torch.empty((P, C), dtype=f, device=dev)
        out_idx = torch.empty((P, C), dtype=i, device=dev)
    check_cuda_operands(name, ref_x=(ref_x, f), out_w=(out_w, f),
                        out_idx=(out_idx, i))
    if out_w.shape != (P, C) or out_idx.shape != (P, C):
        raise ValueError(f"{name}: outputs must be [P, C]")
    pairs, _ = _live_pairs(tile_ids)
    out_w.zero_()
    out_idx.fill_(-1)
    ops = (ref_x, ref_y, ref_t, ref_id, ref_ok, cand_x, cand_y, cand_t,
           cand_id, cand_ok)
    launch(name, *(t.data_ptr() for t in ops), P, C, Mc,
           *_eps(eps_sp, eps_t), pairs.data_ptr(), pairs.shape[0],
           out_w.data_ptr(), out_idx.data_ptr(), device=dev)
    return out_w, out_idx


def best_match_join_pruned(ref: TrajectoryBatch, cand: TrajectoryBatch,
                           eps_sp, eps_t, *, bp: int = JOIN_BP,
                           bc: int = JOIN_BC, max_tiles: int | None = None,
                           return_stats: bool = False):
    """Index-pruned best-match join through K10; bit-identical to the
    dense join.  Plans on the host (the grid is fitted from the data),
    compacts the surviving tiles to a static width K (``max_tiles`` or the
    widest list) and sweeps only those.  Raises if ``max_tiles`` is too
    small to keep every survivor.  ``return_stats=True`` also returns the
    ``PruneStats``."""
    mask, counts, _ = plan_join_index(ref, cand, eps_sp, eps_t, bp=bp, bc=bc)
    tile_ids = _compact(mask, counts, max_tiles, "pruned join")
    T, M = ref.x.shape
    C = cand.x.shape[0]
    best_w = torch.empty((T, M, C), dtype=torch.float32, device=ref.device)
    best_idx = torch.empty((T, M, C), dtype=torch.int32, device=ref.device)
    ref_ops, cand_ops = _flat_operands(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id, cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id)
    stjoin_best_match_pruned(*ref_ops, *cand_ops, tile_ids, eps_sp, eps_t,
                             bp=bp, bc=bc, out_w=best_w.view(T * M, C),
                             out_idx=best_idx.view(T * M, C))
    out = JoinResult(best_w=best_w, best_idx=best_idx)
    if return_stats:
        return out, gridx.prune_stats(counts, mask.shape[1])
    return out


def subtrajectory_join(ref: TrajectoryBatch, cand: TrajectoryBatch,
                       eps_sp, eps_t, delta_t=0.0, *,
                       use_index: bool = False) -> JoinResult:
    """Kernel-backed Problem 1 (join + delta_t refine).  ``use_index=True``
    routes through the grid-pruned K10; the output is identical."""
    if use_index:
        j = best_match_join_pruned(ref, cand, eps_sp, eps_t)
    else:
        j = best_match_join_kernel(ref, cand, eps_sp, eps_t)
    if float(delta_t) > 0.0:
        return filter_delta_t(j, ref.t, delta_t)
    return j


# ---------------------------------------------------------------------------
# Fused streaming join: the [T, M, C] cube is never built.  Pass 1
# (``stjoin_vote_fused``, K2) returns the vote sums and the packed TSA2
# neighbor words; pass 2 (``stjoin_sim_fused``, K4) re-sweeps the join after
# segmentation and scatters the refined weights into the raw similarity
# accumulator.  Both run the delta_t refine inside the kernel.  Both accept
# a ``tile_ids`` plan (``plan_fused_tiles``) to sweep only the surviving
# candidate tiles (K11, K12, K13), with identical outputs.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class FusedTilePlan:
    """A candidate-tile plan bound to the geometry it was built for:
    ``tile_ids`` address blocks of ``bc`` candidates for blocks of
    ``rows`` reference rows, so a plan read under another geometry would
    mis-address candidates.  The pruned kernels take only the port's
    geometry (``FUSED_ROWS``, ``FUSED_BC``); the plain versions any.  The
    live entries are derived once per plan (one host sync) and reused by
    every pass that reads it."""

    tile_ids: torch.Tensor     # [nRb, K] int32, -1 padded, ascending
    rows: int
    bc: int

    @functools.cached_property
    def id_range(self) -> tuple[int, int]:
        """The ids' (min, max), on the host."""
        return _id_range(self.tile_ids)

    @functools.cached_property
    def by_row(self):
        """Live (block, tile) entries, row-major, and their blocks (host)."""
        return _live_pairs(self.tile_ids)

    @functools.cached_property
    def by_tile(self):
        """The same entries tile-major (the plan in transpose), and their
        tiles (host)."""
        return _live_pairs(self.tile_ids, by_tile=True)


def plan_fused_tiles(rx, ry, rt, rvalid, cx, cy, ct, cvalid, eps_sp, eps_t,
                     *, rows: int = FUSED_ROWS, bc: int = FUSED_BC,
                     max_tiles: int | None = None) -> FusedTilePlan:
    """Host-driven candidate-tile plan for the fused passes on raw
    ``[T, M]`` / ``[C, Mc]`` arrays: the two-stage pruning of
    ``plan_join_index`` on blocks of ``rows`` whole reference rows (padded
    to whole blocks) and tiles of ``bc`` candidates (the candidates padded
    to a multiple of 32, as the reference pads them).  ``rows`` is clamped
    to ``[1, T]`` and ``bc`` to a divisor of 32, as the reference's
    ``_fused_geometry`` does.  Raises if ``max_tiles`` would drop a
    survivor.
    """
    T, M = rx.shape
    rows = min(max(rows, 1), max(T, 1))
    bc = max(d for d in (1, 2, 4, 8, 16, 32) if d <= max(bc, 1))
    flat = lambda a, f: _pad_rows(a, rows, f).reshape(-1)
    rboxes = gridx.point_block_boxes(flat(rx, 0.0), flat(ry, 0.0),
                                     flat(rt, 0.0), flat(rvalid, False),
                                     rows * M)
    pad = lambda a, f: _pad_rows(a, 32, f)
    cboxes = gridx.traj_block_boxes(pad(cx, 0.0), pad(cy, 0.0),
                                    pad(ct, 0.0), pad(cvalid, False), bc)
    mask, counts, _ = _tile_mask(rboxes, cboxes, eps_sp, eps_t)
    tile_ids = _compact(mask, counts, max_tiles, "fused pruned sweep")
    return FusedTilePlan(tile_ids=tile_ids, rows=rows, bc=bc)


def _resolve_plan(plan, name: str, cuda: bool, T: int, C: int, dev):
    """The plan of a fused pass: ``None`` or a ``FusedTilePlan`` from
    ``plan_fused_tiles`` (ascending unique ids per row, which K11's word
    zeroing relies on).  On the card the plan must be in the kernels'
    geometry and readable (``_check_tile_ids``)."""
    if plan is None:
        return None
    if not isinstance(plan, FusedTilePlan):
        raise TypeError(f"{name}: tile_ids must be a FusedTilePlan from "
                        f"plan_fused_tiles, got {type(plan).__name__}")
    if cuda:
        if (plan.rows, plan.bc) != (FUSED_ROWS, FUSED_BC):
            raise _geometry_error(name, dict(rows=plan.rows, bc=plan.bc),
                                  dict(rows=FUSED_ROWS, bc=FUSED_BC))
        _check_tile_ids(name, plan.tile_ids, T, -(-C // FUSED_BC), dev,
                        plan.id_range)
    return plan


def _plain_tiles(plan: FusedTilePlan | None, M: int):
    """A fused plan as the plain versions' ``(tile_ids, bp, bc)``."""
    return None if plan is None else (plan.tile_ids, plan.rows * M, plan.bc)


def _check_fused(name, ref_ops, cand_ops, M: int, smem: int):
    """Operand checks of K2 / K4; ``smem`` is the kernel's dynamic shared
    memory (the ``[M][33]`` row tile(s) of ``dsc_kernels.cu``)."""
    f, i, b = torch.float32, torch.int32, torch.bool
    dev = check_cuda_operands(
        name, ref_x=(ref_ops[0], f), ref_y=(ref_ops[1], f),
        ref_t=(ref_ops[2], f), ref_id=(ref_ops[3], i), ref_ok=(ref_ops[4], b),
        cand_x=(cand_ops[0], f), cand_y=(cand_ops[1], f),
        cand_t=(cand_ops[2], f), cand_id=(cand_ops[3], i),
        cand_ok=(cand_ops[4], b))
    if smem > _DYN_SMEM_MAX:
        raise ValueError(f"{name}: the row tile ({smem} bytes for M={M}) "
                         "exceeds one block's shared memory")
    return dev


def stjoin_vote_fused_arrays(rx, ry, rt, rvalid, rid, cx, cy, ct, cvalid,
                             cid, eps_sp, eps_t, delta_t=0.0, *,
                             tile_ids=None, with_masks: bool = True):
    """Fused pass 1 on raw arrays: ``(vote [T, M], words [T, M, ceil(C/32)])``.

    Subsumes ``voting.point_voting`` and ``voting.neighbor_mask_packed``
    over a delta_t-refined join without materializing it.  Words are int32
    bit patterns, bits past C zero.  ``with_masks=False`` (TSA1) returns
    ``(vote, None)`` and writes no words.  ``tile_ids`` (a
    ``plan_fused_tiles`` plan) sweeps only the planned tiles (K11); the
    output is identical.
    """
    T, M = rx.shape
    C, Mc = cx.shape
    name = "stjoin_vote_fused" if tile_ids is None else \
        "stjoin_vote_fused_pruned"
    plan = _resolve_plan(tile_ids, name, rx.is_cuda, T, C, rx.device)
    ref_ops, cand_ops = _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct,
                                       cvalid, cid)
    if not rx.is_cuda:
        vote, words = stjoin_vote_fused_ref(
            *ref_ops, *cand_ops, eps_sp, eps_t, delta_t, M=M,
            with_words=with_masks, tiles=_plain_tiles(plan, M))
    else:
        dev = _check_fused(name, ref_ops, cand_ops, M, M * 34 * 4)
        W = -(-C // 32)
        vote = torch.empty((T * M,), dtype=torch.float32, device=dev)
        words = (torch.empty((T * M, W), dtype=torch.int32, device=dev)
                 if with_masks else None)
        args = (*(t.data_ptr() for t in ref_ops),
                *(t.data_ptr() for t in cand_ops), T, M, C, Mc,
                *_eps(eps_sp, eps_t, delta_t), vote.data_ptr(),
                None if words is None else words.data_ptr(), W)
        if plan is None:
            launch(name, *args, device=dev)
        else:
            launch(name, *args, plan.tile_ids.data_ptr(),
                   plan.tile_ids.shape[1], device=dev)
    return (vote.view(T, M),
            None if words is None else words.view(T, M, -1))


def stjoin_vote_fused(ref: TrajectoryBatch, cand: TrajectoryBatch, eps_sp,
                      eps_t, delta_t=0.0, *, use_index: bool = False,
                      with_masks: bool = True):
    """Batch-level fused pass 1 (vote sums + packed neighbor words);
    ``use_index=True`` plans the tiles (``plan_fused_tiles``) and sweeps
    only the survivors."""
    tile_ids = None
    if use_index:
        tile_ids = plan_fused_tiles(
            ref.x, ref.y, ref.t, ref.valid, cand.x, cand.y, cand.t,
            cand.valid, eps_sp, eps_t)
    return stjoin_vote_fused_arrays(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id, cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id, eps_sp, eps_t, delta_t,
        tile_ids=tile_ids, with_masks=with_masks)


def _check_block_slots(ref_gid, cand_gid, ms: int, n_src: int, n_dst: int,
                       name: str = "stjoin_sim_fused"):
    """The slot contract of K4 and K7: the slots of reference row t lie in
    ``[t*ms, (t+1)*ms)``, those of candidate c in ``[c*ms, (c+1)*ms)``,
    or are the sentinels ``n_src`` / ``n_dst``."""
    T, C = ref_gid.shape[0], cand_gid.shape[0]
    if T * ms != n_src or C * ms != n_dst:
        raise ValueError(f"{name}: n_src={n_src}, n_dst={n_dst} "
                         f"are not T*ms, C*ms for T={T}, C={C}")
    dev = ref_gid.device
    in_block = lambda g, n, k: ((g == n) | (torch.div(
        g, max(ms, 1), rounding_mode="floor") == torch.arange(
            k, device=dev)[:, None])).all()
    if not bool(in_block(ref_gid, n_src, T) & in_block(cand_gid, n_dst, C)):
        raise ValueError(f"{name}: a slot lies outside its "
                         "trajectory's block of ms slots")


def stjoin_sim_fused_arrays(rx, ry, rt, rvalid, rid, ref_gid, cx, cy, ct,
                            cvalid, cid, cand_gid, n_src: int, n_dst: int,
                            eps_sp, eps_t, delta_t=0.0, *, tile_ids=None):
    """Fused pass 2 on raw arrays: raw similarity scatter ``[n_src, n_dst]``.

    ``ref_gid [T, M]``: destination row of each ref point (``n_src`` =
    sentinel).  ``cand_gid [C, Mc]``: destination column of each candidate
    point (``n_dst`` = sentinel).  Normalization is left to
    ``similarity.finalize_sim``.  On the card the slot maps must be the
    DSC ones (``n_src = T*ms``, row t's slots in ``[t*ms, (t+1)*ms)``,
    likewise for candidates), which lets each (row, candidate) pair own
    one ``ms x ms`` block of ``raw``; anything else raises.  ``tile_ids``
    (a ``plan_fused_tiles`` plan) sweeps only the planned tiles (K12); the
    output is identical.
    """
    T, M = rx.shape
    C, Mc = cx.shape
    name = "stjoin_sim_fused" if tile_ids is None else \
        "stjoin_sim_fused_pruned"
    plan = _resolve_plan(tile_ids, name, rx.is_cuda, T, C, rx.device)
    ref_ops, cand_ops = _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct,
                                       cvalid, cid)
    ref_gid = ref_gid.to(torch.int32).contiguous()
    cand_gid = cand_gid.to(torch.int32).contiguous()
    if not rx.is_cuda:
        return stjoin_sim_fused_ref(
            *ref_ops, ref_gid.view(-1), *cand_ops, cand_gid, eps_sp, eps_t,
            delta_t, M=M, n_src=n_src, n_dst=n_dst,
            tiles=_plain_tiles(plan, M))
    ms = n_src // max(T, 1)
    _check_block_slots(ref_gid, cand_gid, ms, n_src, n_dst, name=name)
    dev = _check_fused(name, ref_ops, cand_ops, M,
                       (2 * M * 33 + 32 * (ms * ms + 1)) * 4)
    check_cuda_operands(name, ref_x=(ref_ops[0], torch.float32),
                        ref_gid=(ref_gid, torch.int32),
                        cand_gid=(cand_gid, torch.int32))
    args = (*(t.data_ptr() for t in ref_ops),
            *(t.data_ptr() for t in cand_ops), ref_gid.data_ptr(),
            cand_gid.data_ptr(), T, M, C, Mc, ms,
            *_eps(eps_sp, eps_t, delta_t))
    if plan is None:
        raw = torch.empty((n_src, n_dst), dtype=torch.float32, device=dev)
        launch(name, *args, raw.data_ptr(), device=dev)
        return raw
    # the cells of skipped pairs: the +0.0 K4 writes for a pair without a
    # match
    raw = torch.zeros((n_src, n_dst), dtype=torch.float32, device=dev)
    pairs, _ = plan.by_row
    launch(name, *args, pairs.data_ptr(), pairs.shape[0], raw.data_ptr(),
           device=dev)
    return raw


def stjoin_sim_fused(ref: TrajectoryBatch, cand: TrajectoryBatch,
                     ref_sub_local, cand_sub_local, max_subs: int, eps_sp,
                     eps_t, delta_t=0.0, *, tile_ids=None):
    """Batch-level fused pass 2: un-normalized ``raw [S_ref, S_cand]``.

    Ref point (r, m) scatters into row ``r * max_subs + sub_local[r, m]``;
    the matched candidate point (c, best_idx) into column
    ``c * max_subs + cand_sub_local[c, idx]``.
    """
    n_src, n_dst = ref.num_trajs * max_subs, cand.num_trajs * max_subs
    return stjoin_sim_fused_arrays(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id,
        slot_ids(ref_sub_local, max_subs, n_src), cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id, slot_ids(cand_sub_local, max_subs, n_dst),
        n_src, n_dst, eps_sp, eps_t, delta_t, tile_ids=tile_ids)


def stjoin_sim_panel_fused_arrays(rx, ry, rt, rvalid, rid, ref_gid, cx, cy,
                                  ct, cvalid, cid, cand_gid, n_src: int,
                                  n_dst: int, eps_sp, eps_t, delta_t, p0, *,
                                  panel: int, tile_ids=None):
    """Fused pass 2 for one panel of ``panel`` slots, in both orientations:
    ``(fwd [panel, n_dst], rev [panel, n_src])`` with ``fwd[i, j] =
    raw[p0 + i, j]`` and ``rev[i, j] = raw[j, p0 + i]`` of the ``raw``
    that ``stjoin_sim_fused_arrays`` builds, bit for bit.

    On the card (K7) the slot maps must be the DSC block maps, as for K4;
    then only the rows and the candidates that own a panel slot are swept,
    about ``2 * panel / ms`` trajectories against all, instead of all
    against all.  The panel may split a trajectory's slots.  ``tile_ids``
    (a ``plan_fused_tiles`` plan) sweeps only the planned tiles among
    those (K13); the output is identical.
    """
    T, M = rx.shape
    C, Mc = cx.shape
    name = "stjoin_sim_panel_fused" if tile_ids is None else \
        "stjoin_sim_panel_fused_pruned"
    p0 = int(p0)
    if p0 < 0 or panel < 1 or p0 + panel > min(n_src, n_dst):
        raise ValueError(f"{name}: panel [{p0}, {p0 + panel}) is outside "
                         f"the {n_src} x {n_dst} slots")
    plan = _resolve_plan(tile_ids, name, rx.is_cuda, T, C, rx.device)
    ref_ops, cand_ops = _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct,
                                       cvalid, cid)
    ref_gid = ref_gid.to(torch.int32).contiguous()
    cand_gid = cand_gid.to(torch.int32).contiguous()
    if not rx.is_cuda:
        return stjoin_sim_panel_fused_ref(
            *ref_ops, ref_gid.view(-1), *cand_ops, cand_gid, eps_sp, eps_t,
            delta_t, M=M, n_src=n_src, n_dst=n_dst, p0=p0, panel=panel,
            tiles=_plain_tiles(plan, M))
    ms = n_src // max(T, 1)
    _check_block_slots(ref_gid, cand_gid, ms, n_src, n_dst, name=name)
    dev = _check_fused(name, ref_ops, cand_ops, M,
                       (2 * M * 33 + 32 * (ms * ms + 1)) * 4)
    check_cuda_operands(name, ref_x=(ref_ops[0], torch.float32),
                        ref_gid=(ref_gid, torch.int32),
                        cand_gid=(cand_gid, torch.int32))
    args = (*(t.data_ptr() for t in ref_ops),
            *(t.data_ptr() for t in cand_ops), ref_gid.data_ptr(),
            cand_gid.data_ptr(), T, M, C, Mc, ms, p0, panel,
            *_eps(eps_sp, eps_t, delta_t))
    if plan is None:
        fwd = torch.empty((panel, n_dst), dtype=torch.float32, device=dev)
        rev = torch.empty((panel, n_src), dtype=torch.float32, device=dev)
        launch(name, *args, fwd.data_ptr(), rev.data_ptr(), device=dev)
        return fwd, rev
    # forward: the planned tiles of the rows t_lo..t_hi that own a panel
    # slot; reverse: the plan's rows of the tiles that hold the candidates
    # c_lo..c_hi that own one.  Cells of skipped pairs stay +0.0.
    t_lo, t_hi = p0 // ms, min(T - 1, (p0 + panel - 1) // ms)
    c_lo, c_hi = p0 // ms, min(C - 1, (p0 + panel - 1) // ms)
    fwd_pairs, blocks = plan.by_row
    rev_pairs, tiles = plan.by_tile
    f0, f1 = np.searchsorted(blocks, [t_lo, t_hi + 1])
    r0, r1 = np.searchsorted(tiles, [c_lo // FUSED_BC,
                                     c_hi // FUSED_BC + 1])
    fwd = torch.zeros((panel, n_dst), dtype=torch.float32, device=dev)
    rev = torch.zeros((panel, n_src), dtype=torch.float32, device=dev)
    row = fwd_pairs.stride(0) * fwd_pairs.element_size()
    launch(name, *args, fwd_pairs.data_ptr() + int(f0) * row, int(f1 - f0),
           rev_pairs.data_ptr() + int(r0) * row, int(r1 - r0), c_lo, c_hi,
           fwd.data_ptr(), rev.data_ptr(), device=dev)
    return fwd, rev


def stjoin_sim_panel_fused(ref: TrajectoryBatch, cand: TrajectoryBatch,
                           ref_sub_local, cand_sub_local, max_subs: int,
                           eps_sp, eps_t, delta_t=0.0, *, p0, panel: int,
                           tile_ids=None):
    """Batch-level panel pass 2 (cf. ``stjoin_sim_fused``): the two raw
    orientations of the rows ``[p0, p0 + panel)`` that
    ``core.similarity.topk_stream`` finalizes."""
    n_src, n_dst = ref.num_trajs * max_subs, cand.num_trajs * max_subs
    return stjoin_sim_panel_fused_arrays(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id,
        slot_ids(ref_sub_local, max_subs, n_src), cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id, slot_ids(cand_sub_local, max_subs, n_dst),
        n_src, n_dst, eps_sp, eps_t, delta_t, p0, panel=panel,
        tile_ids=tile_ids)
