"""Public wrappers: TrajectoryBatch- and array-level subtrajectory join
through the join kernels (counterpart of ``repro.kernels.stjoin.ops``:
the dense ``best_match_join_kernel`` and ``subtrajectory_join``, the
fused streaming passes ``stjoin_vote_fused(_arrays)``,
``stjoin_sim_fused(_arrays)`` and ``stjoin_sim_panel_fused(_arrays)`` (or,
for many panels, ``sim_panel_sweep`` / ``prepare_sim_panel``: operands,
checks and the chunk time bounds once, then one launch per panel), and
their index-pruned variants: ``plan_join_index`` /
``best_match_join_pruned`` and ``plan_fused_tiles`` with the ``tile_ids=``
plans of the fused passes).  Every join kernel counts, on request
(``stats=``), the (group, chunk) pairs its time-window skip tests and
skips; ``join_skip_counts`` (K1, K10), ``fused_pairs`` /
``fused_skip_counts`` (K2, K4, K11, K12) and ``SimPanelSweep.pairs`` /
``skip_counts`` (K7, K13) give the plain mirror's counts.  The skip reads
the candidates' chunk time bounds, built by ``chunk_time_bounds``.

Dispatch is on the tensors' device: CUDA tensors launch the CUDA kernels
(``csrc/dsc_kernels.cu``: ``stjoin_best_match``, ``stjoin_vote_fused``,
``stjoin_sim_fused``, ``stjoin_sim_panel_fused`` and their ``*_pruned``
twins K10-K13, and ``chunk_time_bounds``), CPU tensors take the plain
versions in ``ref.py``.
The dense kernels need no padding and no tile geometry: the TPU's
row-aligned blocks and word-aligned candidate blocks are a tiling
constraint of the Pallas kernels, not part of the contract.  A tile plan
is part of the contract: its ids address candidate blocks, so a plan is
bound to its geometry.  The plan functions take the geometry as
arguments, as the reference's do, and default to the port's own CUDA
blocks (``JOIN_BP x JOIN_BC`` for the join, ``FUSED_ROWS x FUSED_BC`` for
the fused passes); the pruned kernels accept only those, the plain
versions any.  Numerics are set out in this package's docstring.

The wrappers also take the reference's TPU knobs with its defaults (``bp``
/ ``bc`` / ``bm`` of the dense join, ``rows`` / ``bc`` / ``bm`` of the
fused passes, ``interpret``), decided from the reference's own outputs:
a knob under which they are bitwise the same is accepted and ignored; the
one that moves them, the vote passes' ``bc`` (the reference sums the
votes in blocks of ``bc`` candidates), is taken only where the reference
resolves it to its default; ``plan_fused_tiles`` records ``bm`` in its
plan, as the reference's does.  A knob no Pallas grid could run is
refused (``check_tile_knobs``).
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
from repro_torch.kernels import check_cuda_operands, check_tile_knobs, launch
from repro_torch.kernels.stjoin.ref import (chunk_time_bounds as
                                            chunk_time_bounds_ref,
                                            panel_skip_counts_ref,
                                            panel_skip_ref,
                                            stjoin_pruned_ref, stjoin_ref,
                                            stjoin_sim_fused_ref,
                                            stjoin_sim_panel_fused_ref,
                                            stjoin_vote_fused_ref, tile_keep)

# the port's tile geometry: K1's block of 64 reference points x 32
# candidates (K10), and the block of K2, K4 and K7, one reference row x
# 32 candidates (K11-K13; a candidate tile is then one packed TSA2 word)
JOIN_BP, JOIN_BC = 64, 32
FUSED_ROWS, FUSED_BC = 1, 32
# the time-window skip of every join kernel: candidate points per chunk of
# the bounds and reference points per group (kChunk and kGroup of
# dsc_kernels.cu)
PANEL_CHUNK = 8
PANEL_GROUP = 8
# elements of one [groups, C, 1, chunks] skip test of ``join_skip_counts``
_SKIP_ELEMENTS = 1 << 24
# the reference's default candidate block of the fused passes, the one
# block whose vote sums the port's stand for (within the stated ulps)
REF_FUSED_BC = 16


def _ref_fused_bc(bc: int) -> int:
    """A fused pass's ``bc`` as the reference resolves it
    (``_fused_geometry``): the largest divisor of 32 not above it."""
    return max(d for d in (1, 2, 4, 8, 16, 32) if d <= max(bc, 1))


def _fused_knobs(name: str, rows, bc, bm, *, vote: bool) -> None:
    """The reference's TPU knobs of a fused pass.  ``rows`` and ``bm``
    leave its outputs bitwise the same, and so does ``bc`` in the
    similarity passes (each cell gets its additions from one tile):
    accepted and ignored.  In the vote passes ``bc`` moves the vote sums
    (blocks of ``bc`` candidates summed, then the blocks added,
    ``stjoin.py:272``); the port sums one candidate at a time in
    ascending order and reproduces no block order, so only a ``bc`` that
    the reference resolves to its default is taken."""
    check_tile_knobs(name, rows=rows, bm=bm)
    if vote and _ref_fused_bc(bc) != REF_FUSED_BC:
        raise ValueError(
            f"{name}: bc={bc!r} moves the reference's vote sums (it sums "
            "blocks of bc candidates, then adds the blocks); the port sums "
            "one candidate at a time and reproduces no block order, so "
            f"only a bc the reference resolves to {REF_FUSED_BC} (16 to "
            "31) is taken")


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


def chunk_time_bounds(t, ok, chunk: int = PANEL_CHUNK):
    """``(lo, hi)`` ``[R, ceil(N / chunk)]`` f32 of ``t [R, N]`` and ``ok``:
    the sweep's chunk time bounds (``ref.chunk_time_bounds``, bit for bit).
    On the card one launch of the ``chunk_time_bounds`` kernel, so a
    sweeping call runs no torch operation for them; on the CPU the plain
    version."""
    if not t.is_cuda:
        return chunk_time_bounds_ref(t, ok, chunk)
    name = "chunk_time_bounds"
    dev = check_cuda_operands(name, t=(t, torch.float32), ok=(ok, torch.bool))
    if t.dim() != 2 or ok.shape != t.shape or chunk < 1:
        raise ValueError(f"{name}: t and ok must be one [R, N] shape and "
                         "chunk >= 1")
    R, N = t.shape
    lo = torch.empty((R, -(-N // chunk)), dtype=torch.float32, device=dev)
    hi = torch.empty_like(lo)
    launch(name, t.data_ptr(), ok.data_ptr(), R, N, chunk, lo.data_ptr(),
           hi.data_ptr(), device=dev)
    return lo, hi


def _check_join(name, ops, out_w, out_idx):
    """Operand and output checks of K1 / K10 on the card: every operand on
    one CUDA device, ``[P, C]`` outputs there (allocated when not given).
    Returns ``(device, out_w, out_idx)``."""
    f, i = torch.float32, torch.int32
    dev = _check_fused(name, ops[:5], ops[5:])
    P, C = ops[0].shape[0], ops[5].shape[0]
    if out_w is None:
        out_w = torch.empty((P, C), dtype=f, device=dev)
        out_idx = torch.empty((P, C), dtype=i, device=dev)
    check_cuda_operands(name, ref_x=(ops[0], f), out_w=(out_w, f),
                        out_idx=(out_idx, i))
    if out_w.shape != (P, C) or out_idx.shape != (P, C):
        raise ValueError(f"{name}: outputs must be [P, C]")
    return dev, out_w, out_idx


def _into(w, idx, out_w, out_idx):
    """A plain version's result, copied into the outputs when given."""
    if out_w is None:
        return w, idx
    out_w.copy_(w)
    out_idx.copy_(idx)
    return out_w, out_idx


def stjoin_best_match(ref_x, ref_y, ref_t, ref_id, ref_ok,
                      cand_x, cand_y, cand_t, cand_id, cand_ok, eps_sp,
                      eps_t, *, out_w=None, out_idx=None, stats=None):
    """``(best_w [P, C] f32, best_idx [P, C] i32)`` — the K1 contract.

    ``out_w`` / ``out_idx`` may name ``[P, C]`` views to write into.
    ``stats``: see ``_check_stats`` (the mirror is ``join_skip_counts``).
    """
    name = "stjoin_best_match"
    ops = (ref_x, ref_y, ref_t, ref_id, ref_ok, cand_x, cand_y, cand_t,
           cand_id, cand_ok)
    if not ref_x.is_cuda:
        _check_stats(name, stats, None)
        return _into(*stjoin_ref(*ops, eps_sp, eps_t), out_w, out_idx)
    dev, out_w, out_idx = _check_join(name, ops, out_w, out_idx)
    _check_stats(name, stats, dev)
    bounds, skip = _chunk_args(ops[5:], stats)
    launch(name, *(t.data_ptr() for t in ops), ref_x.shape[0],
           *cand_x.shape, *_eps(eps_sp, eps_t), *skip, out_w.data_ptr(),
           out_idx.data_ptr(), device=dev)
    return out_w, out_idx


def best_match_join_kernel(ref: TrajectoryBatch, cand: TrajectoryBatch,
                           eps_sp, eps_t, *, bp: int = 256, bc: int = 8,
                           bm: int = 128,
                           interpret: bool | None = None) -> JoinResult:
    """Dense best-match join through K1: ``JoinResult [T, M, C]``.  The
    reference's tile knobs ``bp`` / ``bc`` / ``bm`` and ``interpret``
    leave its outputs bitwise the same and are ignored."""
    check_tile_knobs("best_match_join_kernel", bp=bp, bc=bc, bm=bm)
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


def _tile_mask(rboxes, cboxes, eps_sp, eps_t, use_cells: bool):
    """``(mask [nRb, nCb], counts [nRb] i32, spec)``: the coarse cell test
    on a grid fitted to the candidate tiles, refined by the exact test;
    or (``use_cells=False``) the exact box test of every pair alone, with
    ``spec`` None."""
    spec = None
    if use_cells:
        spec = gridx.fit_grid(cboxes, float(eps_sp), float(eps_t))
        table = gridx.build_cell_table(spec, cboxes)
        mask = gridx.candidate_tile_mask(spec, table, rboxes, cboxes,
                                         eps_sp, eps_t)
    else:
        mask = gridx.exact_pair_mask(rboxes, cboxes, eps_sp, eps_t)
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
                    eps_t, *, bp: int = JOIN_BP, bc: int = JOIN_BC,
                    use_cells: bool = True):
    """Candidate-tile mask of the join, host-driven (the grid is fitted
    from the data): ``(mask [nRb, nCb] bool, counts [nRb] i32, spec)`` for
    blocks of ``bp`` flattened reference points and tiles of ``bc``
    candidate trajectories (both padded with invalid points).
    ``use_cells=False`` skips the grid and tests every pair of boxes
    exactly (``spec`` is then None); the kept tiles are the same."""
    flat = lambda a, f: _pad_rows(a.reshape(-1), bp, f)
    rboxes = gridx.point_block_boxes(flat(ref.x, 0.0), flat(ref.y, 0.0),
                                     flat(ref.t, 0.0), flat(ref.valid, False),
                                     bp)
    pad = lambda a, f: _pad_rows(a, bc, f)
    cboxes = gridx.traj_block_boxes(pad(cand.x, 0.0), pad(cand.y, 0.0),
                                    pad(cand.t, 0.0), pad(cand.valid, False),
                                    bc)
    return _tile_mask(rboxes, cboxes, eps_sp, eps_t, use_cells)


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


def _check_ascending(name: str, tile_ids) -> tuple[int, int]:
    """A join plan K10 walks in order: each row's ids ascending and
    unique, -1 only after the last id (``_compact``'s plans).  Returns the
    ids' (min, max), read with the check in one host sync."""
    a = tile_ids.long()
    bad = (a[:, 1:] >= 0) & ((a[:, :-1] < 0) | (a[:, 1:] <= a[:, :-1]))
    lo, hi, n_bad = (torch.stack([a.min(), a.max(), bad.sum()]).tolist()
                     if a.numel() else (-1, -1, 0))
    if n_bad:
        raise ValueError(f"{name}: each row of tile_ids must list ascending, "
                         "unique ids, -1 only after the last")
    return lo, hi


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
                             bc: int = JOIN_BC, out_w=None, out_idx=None,
                             stats=None):
    """K10: ``(best_w [P, C] f32, best_idx [P, C] i32)`` of K1 over the
    (block of ``bp`` points, tile of ``bc`` candidates) pairs that
    ``tile_ids [ceil(P / bp), K]`` names; ``(0, -1)`` elsewhere.  Each
    row of the plan must list ascending, unique ids, -1 only after the
    last (``ValueError`` otherwise, on either device): the kernel walks
    them in order.  ``stats``: see ``_check_stats`` (the mirror is
    ``join_skip_counts``)."""
    name = "stjoin_best_match_pruned"
    ops = (ref_x, ref_y, ref_t, ref_id, ref_ok, cand_x, cand_y, cand_t,
           cand_id, cand_ok)
    if not ref_x.is_cuda:
        _check_stats(name, stats, None)
        _check_ascending(name, tile_ids)
        return _into(*stjoin_pruned_ref(*ops, tile_ids, eps_sp, eps_t,
                                        bp=bp, bc=bc), out_w, out_idx)
    _check_join_geometry(name, bp, bc)
    dev, out_w, out_idx = _check_join(name, ops, out_w, out_idx)
    _check_stats(name, stats, dev)
    P = ref_x.shape[0]
    C, Mc = cand_x.shape
    _check_tile_ids(name, tile_ids, -(-P // bp), -(-C // bc), dev,
                    _check_ascending(name, tile_ids))
    bounds, skip = _chunk_args(ops[5:], stats)
    launch(name, *(t.data_ptr() for t in ops), P, C, Mc,
           *_eps(eps_sp, eps_t), tile_ids.data_ptr(), tile_ids.shape[1],
           *skip, out_w.data_ptr(), out_idx.data_ptr(), device=dev)
    return out_w, out_idx


def join_skip_counts(rt, rok, ct, cok, eps_t, *, tile_ids=None):
    """``(swept, skipped)`` (group, chunk) pairs of one launch of K1 (K10
    with the join plan ``tile_ids``, in the port's geometry) on reference
    times ``rt`` / ``rok`` (flattened: the groups are runs of 8
    consecutive flattened points, which may straddle rows) and candidate
    times ``ct`` / ``cok [C, Mc]``: every (group, candidate) pair, or those
    of the plan's kept (block, tile) pairs, each with its ceil(Mc / 8)
    chunks; a pair is skipped by ``ref.panel_skip_ref``.  What the kernels'
    ``stats`` must hold."""
    g_lo, g_hi = (b[0] for b in chunk_time_bounds_ref(
        rt.reshape(1, -1), rok.reshape(1, -1), PANEL_GROUP))
    c_lo, c_hi = chunk_time_bounds_ref(ct.contiguous(), cok.contiguous(),
                                       PANEL_CHUNK)
    C, nch = c_lo.shape
    G = g_lo.shape[0]
    dev = g_lo.device
    per_block = JOIN_BP // PANEL_GROUP
    keep = None if tile_ids is None else \
        tile_keep(tile_ids, -(-C // JOIN_BC))[:, torch.div(
            torch.arange(C, device=dev), JOIN_BC, rounding_mode="floor")]
    step = max(1, _SKIP_ELEMENTS // max(C * nch, 1))
    swept = skipped = 0
    for g0 in range(0, G, step):
        g = slice(g0, g0 + step)
        n = panel_skip_ref(g_lo[g, None, None], g_hi[g, None, None], c_lo,
                           c_hi, eps_t).sum((-2, -1))        # [groups, C]
        if keep is None:
            swept += n.numel() * nch
            skipped += int(n.sum())
        else:
            k = keep[torch.div(torch.arange(g0, g0 + n.shape[0], device=dev),
                               per_block, rounding_mode="floor")]
            swept += int(k.sum()) * nch
            skipped += int(n[k].sum())
    return swept, skipped


def best_match_join_pruned(ref: TrajectoryBatch, cand: TrajectoryBatch,
                           eps_sp, eps_t, *, bp: int = JOIN_BP,
                           bc: int = JOIN_BC, bm: int = 128,
                           max_tiles: int | None = None,
                           use_cells: bool = True,
                           interpret: bool | None = None,
                           return_stats: bool = False):
    """Index-pruned best-match join through K10; bit-identical to the
    dense join.  Plans on the host (the grid is fitted from the data;
    ``use_cells`` as in ``plan_join_index``), compacts the surviving tiles
    to a static width K (``max_tiles`` or the widest list) and sweeps only
    those.  Raises if ``max_tiles`` is too small to keep every survivor.
    ``return_stats=True`` also returns the ``PruneStats``.  ``bp`` / ``bc``
    are the plan's geometry (K10 takes only its own); the reference's
    ``bm`` and ``interpret`` leave its outputs bitwise the same and are
    ignored."""
    check_tile_knobs("best_match_join_pruned", bm=bm)
    mask, counts, _ = plan_join_index(ref, cand, eps_sp, eps_t, bp=bp, bc=bc,
                                      use_cells=use_cells)
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
                       use_index: bool = False, **kw) -> JoinResult:
    """Kernel-backed Problem 1 (join + delta_t refine).  ``use_index=True``
    routes through the grid-pruned K10; the output is identical.  ``kw``
    goes to ``best_match_join_pruned`` or ``best_match_join_kernel``, as
    in the reference."""
    if use_index:
        j = best_match_join_pruned(ref, cand, eps_sp, eps_t, **kw)
    else:
        j = best_match_join_kernel(ref, cand, eps_sp, eps_t, **kw)
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
    bm: int = 128              # the reference's point chunk (not read)

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
                     bm: int = 128, use_cells: bool = True,
                     max_tiles: int | None = None) -> FusedTilePlan:
    """Host-driven candidate-tile plan for the fused passes on raw
    ``[T, M]`` / ``[C, Mc]`` arrays: the two-stage pruning of
    ``plan_join_index`` on blocks of ``rows`` whole reference rows (padded
    to whole blocks) and tiles of ``bc`` candidates (the candidates padded
    to a multiple of 32, as the reference pads them).  ``rows`` is clamped
    to ``[1, T]`` and ``bc`` to a divisor of 32, as the reference's
    ``_fused_geometry`` does.  ``bm`` (the reference's candidate point
    chunk) does not change the tiles; the plan records ``min(bm, Mc)``, as
    the reference's does.  ``use_cells=False`` tests every pair of
    boxes exactly, without the grid.  Raises if ``max_tiles`` would drop a
    survivor.
    """
    check_tile_knobs("plan_fused_tiles", bm=bm)
    T, M = rx.shape
    rows = min(max(rows, 1), max(T, 1))
    bc = _ref_fused_bc(bc)
    flat = lambda a, f: _pad_rows(a, rows, f).reshape(-1)
    rboxes = gridx.point_block_boxes(flat(rx, 0.0), flat(ry, 0.0),
                                     flat(rt, 0.0), flat(rvalid, False),
                                     rows * M)
    pad = lambda a, f: _pad_rows(a, 32, f)
    cboxes = gridx.traj_block_boxes(pad(cx, 0.0), pad(cy, 0.0),
                                    pad(ct, 0.0), pad(cvalid, False), bc)
    mask, counts, _ = _tile_mask(rboxes, cboxes, eps_sp, eps_t, use_cells)
    tile_ids = _compact(mask, counts, max_tiles, "fused pruned sweep")
    return FusedTilePlan(tile_ids=tile_ids, rows=rows, bc=bc,
                         bm=min(bm, cx.shape[1]))


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


def _check_fused(name, ref_ops, cand_ops, **more):
    """Operand checks of the join kernels on the card: every operand (and
    ``more``: name -> (tensor, dtype)) on one CUDA device.  The launchers
    refuse a row too long for one block's shared memory themselves
    (``RuntimeError``)."""
    f, i, b = torch.float32, torch.int32, torch.bool
    return check_cuda_operands(
        name, ref_x=(ref_ops[0], f), ref_y=(ref_ops[1], f),
        ref_t=(ref_ops[2], f), ref_id=(ref_ops[3], i), ref_ok=(ref_ops[4], b),
        cand_x=(cand_ops[0], f), cand_y=(cand_ops[1], f),
        cand_t=(cand_ops[2], f), cand_id=(cand_ops[3], i),
        cand_ok=(cand_ops[4], b), **more)


def _check_stats(name: str, stats, dev) -> None:
    """``stats`` of a join kernel: ``None``, or (on the card, ``dev``) an
    int64 tensor of 2 on that device, to which the kernel adds the (group,
    chunk) pairs it tested and those it skipped.  The plain versions
    (``dev`` None) sweep no groups and refuse it."""
    if stats is not None and not (
            dev is not None and stats.dtype == torch.int64
            and stats.numel() == 2 and stats.device == dev):
        raise ValueError(f"{name}: stats must be an int64 tensor of 2 on "
                         "the operands' CUDA device")


def _chunk_args(cand_ops, stats):
    """The launch arguments of the time-window skip: the candidates' chunk
    time bounds (built once per call by ``chunk_time_bounds``; kept alive
    by the caller) and the ``stats`` pointer."""
    lo, hi = chunk_time_bounds(cand_ops[2], cand_ops[4])
    return (lo, hi), (lo.data_ptr(), hi.data_ptr(),
                      None if stats is None else stats.data_ptr())


def _entry_pairs(entries: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The (row t, candidate c) pairs of live plan entries ``[n, 2]`` (row
    t, tile j): the tile's candidates in ``[lo, hi]``, ``[m, 2]`` int64."""
    e = entries.long()
    c = e[:, 1:] * FUSED_BC + torch.arange(FUSED_BC, device=e.device)
    keep = (c >= lo) & (c <= hi)
    t = e[:, :1].expand_as(c)
    return torch.stack([t[keep], c[keep]], dim=1)


def fused_pairs(T: int, C: int, tile_ids=None, *, device=None):
    """The (reference row t, candidate c) pairs one launch of K2 / K4 sweeps
    (every row against every candidate), or of K11 / K12 with the plan
    ``tile_ids`` (each row against the candidates of its planned tiles),
    ``[n, 2]`` int64; the kernels' ``stats`` count the (group, chunk) pairs
    of these (``panel_skip_counts_ref``)."""
    if tile_ids is None:
        return torch.cartesian_prod(torch.arange(T, device=device),
                                    torch.arange(C, device=device)
                                    ).view(-1, 2)
    if (tile_ids.rows, tile_ids.bc) != (FUSED_ROWS, FUSED_BC):
        raise _geometry_error("fused_pairs", dict(rows=tile_ids.rows,
                                                  bc=tile_ids.bc),
                              dict(rows=FUSED_ROWS, bc=FUSED_BC))
    return _entry_pairs(tile_ids.by_row[0], 0, C - 1)


def fused_skip_counts(rt, rvalid, ct, cvalid, eps_t, *, tile_ids=None):
    """``(swept, skipped)`` (group, chunk) pairs of one launch of K2 / K4
    (K11 / K12 with the plan ``tile_ids``) on ``[T, M]`` / ``[C, Mc]``
    times, from the plain mirror ``panel_skip_counts_ref`` over
    ``fused_pairs``: what the kernels' ``stats`` must hold."""
    T, M = rt.shape
    lo, hi = chunk_time_bounds_ref(ct.contiguous(), cvalid.contiguous(),
                                   PANEL_CHUNK)
    return panel_skip_counts_ref(
        rt.reshape(-1), rvalid.reshape(-1), M, lo, hi, eps_t,
        fused_pairs(T, ct.shape[0], tile_ids, device=rt.device),
        group=PANEL_GROUP)


def stjoin_vote_fused_arrays(rx, ry, rt, rvalid, rid, cx, cy, ct, cvalid,
                             cid, eps_sp, eps_t, delta_t=0.0, *,
                             rows: int | None = None, bc: int = 16,
                             bm: int = 128, tile_ids=None,
                             with_masks: bool = True,
                             interpret: bool | None = None, stats=None):
    """Fused pass 1 on raw arrays: ``(vote [T, M], words [T, M, ceil(C/32)])``.

    Subsumes ``voting.point_voting`` and ``voting.neighbor_mask_packed``
    over a delta_t-refined join without materializing it.  Words are int32
    bit patterns, bits past C zero.  ``with_masks=False`` (TSA1) returns
    ``(vote, None)`` and writes no words.  ``tile_ids`` (a
    ``plan_fused_tiles`` plan) sweeps only the planned tiles (K11); the
    output is identical.  ``stats``: see ``_check_stats`` (the mirror is
    ``fused_skip_counts``).  A row too long for one block's shared memory
    is refused by the launcher (``RuntimeError``).  The reference's knobs:
    ``_fused_knobs``.
    """
    T, M = rx.shape
    C, Mc = cx.shape
    name = "stjoin_vote_fused" if tile_ids is None else \
        "stjoin_vote_fused_pruned"
    _fused_knobs(name, rows, bc, bm, vote=True)
    plan = _resolve_plan(tile_ids, name, rx.is_cuda, T, C, rx.device)
    ref_ops, cand_ops = _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct,
                                       cvalid, cid)
    if not rx.is_cuda:
        _check_stats(name, stats, None)
        vote, words = stjoin_vote_fused_ref(
            *ref_ops, *cand_ops, eps_sp, eps_t, delta_t, M=M,
            with_words=with_masks, tiles=_plain_tiles(plan, M))
    else:
        dev = _check_fused(name, ref_ops, cand_ops)
        _check_stats(name, stats, dev)
        W = -(-C // 32)
        vote = torch.empty((T * M,), dtype=torch.float32, device=dev)
        words = (torch.empty((T * M, W), dtype=torch.int32, device=dev)
                 if with_masks else None)
        bounds, skip = _chunk_args(cand_ops, stats)
        args = (*(t.data_ptr() for t in ref_ops),
                *(t.data_ptr() for t in cand_ops), T, M, C, Mc,
                *_eps(eps_sp, eps_t, delta_t), *skip, vote.data_ptr(),
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
                      use_cells: bool = True, max_tiles: int | None = None,
                      rows: int | None = None, bc: int = 16, bm: int = 128,
                      with_masks: bool = True,
                      interpret: bool | None = None, stats=None):
    """Batch-level fused pass 1 (vote sums + packed neighbor words);
    ``use_index=True`` plans the tiles (``plan_fused_tiles`` at the
    kernels' geometry, with ``use_cells``, ``max_tiles`` and ``bm``) and
    sweeps only the survivors.  The reference's knobs: ``_fused_knobs``."""
    _fused_knobs("stjoin_vote_fused", rows, bc, bm, vote=True)
    tile_ids = None
    if use_index:
        tile_ids = plan_fused_tiles(
            ref.x, ref.y, ref.t, ref.valid, cand.x, cand.y, cand.t,
            cand.valid, eps_sp, eps_t, bm=bm, use_cells=use_cells,
            max_tiles=max_tiles)
    return stjoin_vote_fused_arrays(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id, cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id, eps_sp, eps_t, delta_t,
        tile_ids=tile_ids, with_masks=with_masks, stats=stats)


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
                            eps_sp, eps_t, delta_t=0.0, *,
                            rows: int | None = None, bc: int = 16,
                            bm: int = 128, tile_ids=None,
                            interpret: bool | None = None, stats=None):
    """Fused pass 2 on raw arrays: raw similarity scatter ``[n_src, n_dst]``.

    ``ref_gid [T, M]``: destination row of each ref point (``n_src`` =
    sentinel).  ``cand_gid [C, Mc]``: destination column of each candidate
    point (``n_dst`` = sentinel).  Normalization is left to
    ``similarity.finalize_sim``.  On the card the slot maps must be the
    DSC ones (``n_src = T*ms``, row t's slots in ``[t*ms, (t+1)*ms)``,
    likewise for candidates), which lets each (row, candidate) pair own
    one ``ms x ms`` block of ``raw``; anything else raises.  ``tile_ids``
    (a ``plan_fused_tiles`` plan) sweeps only the planned tiles (K12); the
    output is identical.  ``stats``: see ``_check_stats`` (the mirror is
    ``fused_skip_counts``).  A row too long for one block's shared memory
    is refused by the launcher (``RuntimeError``).  The reference's knobs:
    ``_fused_knobs``.
    """
    T, M = rx.shape
    C, Mc = cx.shape
    name = "stjoin_sim_fused" if tile_ids is None else \
        "stjoin_sim_fused_pruned"
    _fused_knobs(name, rows, bc, bm, vote=False)
    plan = _resolve_plan(tile_ids, name, rx.is_cuda, T, C, rx.device)
    ref_ops, cand_ops = _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct,
                                       cvalid, cid)
    ref_gid = ref_gid.to(torch.int32).contiguous()
    cand_gid = cand_gid.to(torch.int32).contiguous()
    if not rx.is_cuda:
        _check_stats(name, stats, None)
        return stjoin_sim_fused_ref(
            *ref_ops, ref_gid.view(-1), *cand_ops, cand_gid, eps_sp, eps_t,
            delta_t, M=M, n_src=n_src, n_dst=n_dst,
            tiles=_plain_tiles(plan, M))
    ms = n_src // max(T, 1)
    _check_block_slots(ref_gid, cand_gid, ms, n_src, n_dst, name=name)
    dev = _check_fused(name, ref_ops, cand_ops,
                       ref_gid=(ref_gid, torch.int32),
                       cand_gid=(cand_gid, torch.int32))
    _check_stats(name, stats, dev)
    bounds, skip = _chunk_args(cand_ops, stats)
    args = (*(t.data_ptr() for t in ref_ops),
            *(t.data_ptr() for t in cand_ops), ref_gid.data_ptr(),
            cand_gid.data_ptr(), T, M, C, Mc, ms,
            *_eps(eps_sp, eps_t, delta_t))
    if plan is None:
        raw = torch.empty((n_src, n_dst), dtype=torch.float32, device=dev)
        launch(name, *args, *skip, raw.data_ptr(), device=dev)
        return raw
    # the cells of skipped pairs: the +0.0 K4 writes for a pair without a
    # match
    raw = torch.zeros((n_src, n_dst), dtype=torch.float32, device=dev)
    pairs, _ = plan.by_row
    launch(name, *args, pairs.data_ptr(), pairs.shape[0], *skip,
           raw.data_ptr(), device=dev)
    return raw


def stjoin_sim_fused(ref: TrajectoryBatch, cand: TrajectoryBatch,
                     ref_sub_local, cand_sub_local, max_subs: int, eps_sp,
                     eps_t, delta_t=0.0, *, tile_ids=None,
                     rows: int | None = None, bc: int = 16, bm: int = 128,
                     interpret: bool | None = None, stats=None):
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
        n_src, n_dst, eps_sp, eps_t, delta_t, rows=rows, bc=bc, bm=bm,
        tile_ids=tile_ids, stats=stats)


@dataclasses.dataclass(frozen=True, eq=False)
class SimPanelSweep:
    """The panel pass 2 of one dispatch: operands flattened, slot maps and
    plan checked, and the candidates' chunk time bounds built once (at the
    first panel, after its checks), for every panel.  ``sweep(p0,
    panel=Sb)`` gives ``(fwd [panel, n_dst], rev [panel, n_src])`` with
    ``fwd[i, j] = raw[p0 + i, j]`` and ``rev[i, j] = raw[j, p0 + i]`` of
    the ``raw`` that ``stjoin_sim_fused_arrays`` builds,
    bit for bit: through K7 (or K13 with a plan) on the card, through
    ``stjoin_sim_panel_fused_ref`` on the CPU.  Build it with
    ``prepare_sim_panel`` or ``sim_panel_sweep``; the check of the slot
    maps (one host sync) happens there, not per panel."""

    on_card: bool              # launch K7 / K13 (else the plain version)

    ref_ops: tuple
    cand_ops: tuple
    ref_gid: torch.Tensor      # [T, M] int32
    cand_gid: torch.Tensor     # [C, Mc] int32
    n_src: int
    n_dst: int
    eps: tuple                 # eps_sp, eps_t, delta_t (f32 values)
    plan: FusedTilePlan | None

    @functools.cached_property
    def _bounds(self):
        return chunk_time_bounds(self.cand_ops[2], self.cand_ops[4])

    @property
    def chunk_lo(self) -> torch.Tensor:
        """``[C, ceil(Mc / PANEL_CHUNK)]`` f32: the candidates' chunk
        bounds (``chunk_time_bounds``)."""
        return self._bounds[0]

    @property
    def chunk_hi(self) -> torch.Tensor:
        return self._bounds[1]

    @property
    def name(self) -> str:
        return "stjoin_sim_panel_fused" + ("" if self.plan is None
                                           else "_pruned")

    @property
    def shape(self):
        """``(T, M, C, Mc)``."""
        return (*self.ref_gid.shape, *self.cand_gid.shape)

    def _geometry(self, p0: int, panel: int):
        """``(ms, t_lo, t_hi, c_lo, c_hi)``: the rows and the candidates
        that own a slot of the panel; raises if it leaves the slots."""
        if p0 < 0 or panel < 1 or p0 + panel > min(self.n_src, self.n_dst):
            raise ValueError(f"{self.name}: panel [{p0}, {p0 + panel}) is "
                             f"outside the {self.n_src} x {self.n_dst} "
                             "slots")
        T, _, C, _ = self.shape
        ms = max(self.n_src // max(T, 1), 1)
        return (ms, p0 // ms, min(T - 1, (p0 + panel - 1) // ms), p0 // ms,
                min(C - 1, (p0 + panel - 1) // ms))

    def _plan_slices(self, t_lo, t_hi, c_lo, c_hi):
        """The plan's live entries of the panel: ``(fwd_pairs, rev_pairs)``
        views of its row-major entries of rows t_lo..t_hi and of its
        tile-major entries of the tiles that hold c_lo..c_hi."""
        fwd_pairs, blocks = self.plan.by_row
        rev_pairs, tiles = self.plan.by_tile
        f0, f1 = np.searchsorted(blocks, [t_lo, t_hi + 1])
        r0, r1 = np.searchsorted(tiles, [c_lo // FUSED_BC,
                                         c_hi // FUSED_BC + 1])
        return fwd_pairs[f0:f1], rev_pairs[r0:r1]

    def pairs(self, p0, *, panel: int) -> torch.Tensor:
        """The (row t, candidate c) pairs the panel's kernel sweeps,
        ``[n, 2]`` int64: forward, the rows that own a panel slot against
        every candidate (with a plan: of their planned tiles); reverse,
        every row (the plan's rows) against the panel's candidates."""
        ms, t_lo, t_hi, c_lo, c_hi = self._geometry(int(p0), panel)
        T, _, C, _ = self.shape
        dev = self.ref_gid.device
        ar = lambda a, b: torch.arange(a, b, device=dev)
        if self.plan is None:
            fwd = torch.cartesian_prod(ar(t_lo, t_hi + 1), ar(0, C))
            rev = torch.cartesian_prod(ar(0, T), ar(c_lo, c_hi + 1))
            return torch.cat([fwd, rev])
        if (self.plan.rows, self.plan.bc) != (FUSED_ROWS, FUSED_BC):
            raise _geometry_error(self.name, dict(rows=self.plan.rows,
                                                  bc=self.plan.bc),
                                  dict(rows=FUSED_ROWS, bc=FUSED_BC))
        fwd, rev = self._plan_slices(t_lo, t_hi, c_lo, c_hi)
        return torch.cat([_entry_pairs(fwd, 0, C - 1),
                          _entry_pairs(rev, c_lo, c_hi)])

    def skip_counts(self, p0, *, panel: int) -> tuple[int, int]:
        """``(swept, skipped)`` (group, chunk) pairs of the panel's kernel,
        from the plain mirror ``panel_skip_counts_ref``."""
        T, M, _, _ = self.shape
        lo, hi = chunk_time_bounds_ref(self.cand_ops[2], self.cand_ops[4],
                                       PANEL_CHUNK)
        return panel_skip_counts_ref(
            self.ref_ops[2], self.ref_ops[4], M, lo, hi, self.eps[1],
            self.pairs(p0, panel=panel), group=PANEL_GROUP)

    def __call__(self, p0, *, panel: int, stats=None):
        """One panel: ``(fwd, rev)``.  ``stats``: see ``_check_stats``
        (the mirror is ``skip_counts``)."""
        p0 = int(p0)
        ms, t_lo, t_hi, c_lo, c_hi = self._geometry(p0, panel)
        _check_stats(self.name, stats,
                     self.ref_gid.device if self.on_card else None)
        T, M, C, Mc = self.shape
        if not self.on_card:
            return stjoin_sim_panel_fused_ref(
                *self.ref_ops, self.ref_gid.view(-1), *self.cand_ops,
                self.cand_gid, *self.eps, M=M, n_src=self.n_src,
                n_dst=self.n_dst, p0=p0, panel=panel,
                tiles=_plain_tiles(self.plan, M))
        dev = self.ref_gid.device
        args = (*(t.data_ptr() for t in self.ref_ops),
                *(t.data_ptr() for t in self.cand_ops),
                self.ref_gid.data_ptr(), self.cand_gid.data_ptr(), T, M, C,
                Mc, ms, p0, panel, *self.eps)
        tail = (self.chunk_lo.data_ptr(), self.chunk_hi.data_ptr(),
                None if stats is None else stats.data_ptr())
        if self.plan is None:
            fwd = torch.empty((panel, self.n_dst), dtype=torch.float32,
                              device=dev)
            rev = torch.empty((panel, self.n_src), dtype=torch.float32,
                              device=dev)
            launch(self.name, *args, *tail, fwd.data_ptr(), rev.data_ptr(),
                   device=dev)
            return fwd, rev
        # forward: the planned tiles of the rows t_lo..t_hi that own a panel
        # slot; reverse: the plan's rows of the tiles that hold the
        # candidates c_lo..c_hi that own one.  Cells of skipped pairs stay
        # +0.0.
        fwd_pairs, rev_pairs = self._plan_slices(t_lo, t_hi, c_lo, c_hi)
        fwd = torch.zeros((panel, self.n_dst), dtype=torch.float32,
                          device=dev)
        rev = torch.zeros((panel, self.n_src), dtype=torch.float32,
                          device=dev)
        launch(self.name, *args, fwd_pairs.data_ptr(), fwd_pairs.shape[0],
               rev_pairs.data_ptr(), rev_pairs.shape[0], c_lo, c_hi, *tail,
               fwd.data_ptr(), rev.data_ptr(), device=dev)
        return fwd, rev


def prepare_sim_panel(rx, ry, rt, rvalid, rid, ref_gid, cx, cy, ct, cvalid,
                      cid, cand_gid, n_src: int, n_dst: int, eps_sp, eps_t,
                      delta_t, *, tile_ids=None) -> SimPanelSweep:
    """The panel pass 2 on raw arrays (cf. ``stjoin_sim_fused_arrays``),
    prepared for many panels: a ``SimPanelSweep``.

    On the card (K7) the slot maps must be the DSC block maps, as for K4;
    then only the rows and the candidates that own a panel slot are swept,
    about ``2 * panel / ms`` trajectories against all, instead of all
    against all, and of those only the chunks of candidate points within
    eps_t of each group of reference points.  The panel may split a
    trajectory's slots.  ``tile_ids`` (a ``plan_fused_tiles`` plan) sweeps
    only the planned tiles among those (K13); the output is identical.
    The kernel runs when any operand lies on the card, and then all must
    lie on that one card.  A shape whose staged window does not fit one
    block's shared memory is refused by the launcher (``RuntimeError``).
    """
    T, M = rx.shape
    C, Mc = cx.shape
    name = "stjoin_sim_panel_fused" if tile_ids is None else \
        "stjoin_sim_panel_fused_pruned"
    ref_ops, cand_ops = _flat_operands(rx, ry, rt, rvalid, rid, cx, cy, ct,
                                       cvalid, cid)
    ref_gid = ref_gid.to(torch.int32).contiguous()
    cand_gid = cand_gid.to(torch.int32).contiguous()
    on_card = any(a.is_cuda for a in (*ref_ops, *cand_ops, ref_gid,
                                      cand_gid))
    if on_card:
        _check_fused(name, ref_ops, cand_ops,
                     ref_gid=(ref_gid, torch.int32),
                     cand_gid=(cand_gid, torch.int32))
        _check_block_slots(ref_gid, cand_gid, n_src // max(T, 1), n_src,
                           n_dst, name=name)
    plan = _resolve_plan(tile_ids, name, on_card, T, C, rx.device)
    return SimPanelSweep(on_card=on_card, ref_ops=ref_ops,
                         cand_ops=cand_ops, ref_gid=ref_gid,
                         cand_gid=cand_gid, n_src=n_src, n_dst=n_dst,
                         eps=_eps(eps_sp, eps_t, delta_t), plan=plan)


def sim_panel_sweep(ref: TrajectoryBatch, cand: TrajectoryBatch,
                    ref_sub_local, cand_sub_local, max_subs: int, eps_sp,
                    eps_t, delta_t=0.0, *, tile_ids=None) -> SimPanelSweep:
    """Batch-level ``prepare_sim_panel`` (cf. ``stjoin_sim_fused``): the
    panels of the raw rows that ``core.similarity.topk_stream``
    finalizes."""
    n_src, n_dst = ref.num_trajs * max_subs, cand.num_trajs * max_subs
    return prepare_sim_panel(
        ref.x, ref.y, ref.t, ref.valid, ref.traj_id,
        slot_ids(ref_sub_local, max_subs, n_src), cand.x, cand.y, cand.t,
        cand.valid, cand.traj_id, slot_ids(cand_sub_local, max_subs, n_dst),
        n_src, n_dst, eps_sp, eps_t, delta_t, tile_ids=tile_ids)


def stjoin_sim_panel_fused_arrays(rx, ry, rt, rvalid, rid, ref_gid, cx, cy,
                                  ct, cvalid, cid, cand_gid, n_src: int,
                                  n_dst: int, eps_sp, eps_t, delta_t, p0, *,
                                  panel: int, tile_ids=None,
                                  rows: int | None = None, bc: int = 16,
                                  bm: int = 128,
                                  interpret: bool | None = None,
                                  stats=None):
    """Fused pass 2 for one panel of ``panel`` slots, in both orientations
    (``prepare_sim_panel`` for this one panel, its checks included):
    ``(fwd [panel, n_dst], rev [panel, n_src])``, bit for bit the rows and
    transposed columns of ``stjoin_sim_fused_arrays``'s ``raw``.  The
    reference's knobs: ``_fused_knobs``."""
    _fused_knobs("stjoin_sim_panel_fused", rows, bc, bm, vote=False)
    return prepare_sim_panel(
        rx, ry, rt, rvalid, rid, ref_gid, cx, cy, ct, cvalid, cid, cand_gid,
        n_src, n_dst, eps_sp, eps_t, delta_t, tile_ids=tile_ids)(
            p0, panel=panel, stats=stats)


def stjoin_sim_panel_fused(ref: TrajectoryBatch, cand: TrajectoryBatch,
                           ref_sub_local, cand_sub_local, max_subs: int,
                           eps_sp, eps_t, delta_t=0.0, *, p0, panel: int,
                           tile_ids=None, rows: int | None = None,
                           bc: int = 16, bm: int = 128,
                           interpret: bool | None = None, stats=None):
    """Batch-level panel pass 2 (cf. ``stjoin_sim_fused``): the two raw
    orientations of the rows ``[p0, p0 + panel)`` that
    ``core.similarity.topk_stream`` finalizes.  The reference's knobs:
    ``_fused_knobs``."""
    _fused_knobs("stjoin_sim_panel_fused", rows, bc, bm, vote=False)
    return sim_panel_sweep(ref, cand, ref_sub_local, cand_sub_local,
                           max_subs, eps_sp, eps_t, delta_t,
                           tile_ids=tile_ids)(p0, panel=panel, stats=stats)
