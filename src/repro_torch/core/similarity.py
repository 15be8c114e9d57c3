"""Subtrajectory similarity (Eq. 2) and the ST / SP relations — the dense
representation (counterpart of the dense part of
``repro.core.similarity``; the top-K engine is ROADMAP queue 1 item 7).

Every join match ``(ref point (r, m) <-> best point of candidate c)``
adds its weight ``1 - d_s/eps_sp`` to the (sub(r, m), sub(c, best_idx))
cell of the ``[S, S]`` matrix; Eq. 2 divides by ``min(|r'|, |s'|)`` and
the matrix is max-symmetrized (DESIGN.md §2.4).

The order of the float additions into a cell is the reference's flat
(t, m, c) order: the scatter uses ``index_put_(accumulate=True)``, which
is serial on the CPU and sort-based (deterministic) on the card, never a
float atomic.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import (JoinResult, SubtrajSegmentation,
                                    SubtrajTable, TrajectoryBatch)

# contributions per scatter chunk (bounds the int64 index temporaries)
SCATTER_ELEMENTS = 1 << 25
# rows per chunk of the [S, S] row passes
ROW_CHUNK = 4096


def build_subtraj_table(batch: TrajectoryBatch, seg: SubtrajSegmentation,
                        vote: torch.Tensor, max_subs: int) -> SubtrajTable:
    """The ST relation: (t_start, t_end, V, Card) per (traj, local sub) slot."""
    return build_subtraj_table_arrays(batch.t, batch.valid, seg.sub_local,
                                      vote, max_subs)


def build_subtraj_table_arrays(t, valid, sub_local, vote,
                               max_subs: int) -> SubtrajTable:
    T, M = t.shape
    S = T * max_subs
    dev = t.device
    rows = torch.arange(T, device=dev)[:, None]
    flat = torch.where(sub_local >= 0, rows * max_subs + sub_local,
                       S).reshape(-1)
    big = 3.4e38
    t_start = torch.full((S + 1,), big, device=dev).scatter_reduce(
        0, flat, torch.where(valid, t, big).reshape(-1), "amin")[:S]
    t_end = torch.full((S + 1,), -big, device=dev).scatter_reduce(
        0, flat, torch.where(valid, t, -big).reshape(-1), "amax")[:S]
    card = torch.zeros((S + 1,), dtype=torch.int32, device=dev).index_put_(
        (flat,), valid.reshape(-1).to(torch.int32), accumulate=True)[:S]
    vsum = torch.zeros((S + 1,), dtype=torch.float32, device=dev).index_put_(
        (flat,), torch.where(valid, vote, 0.0).reshape(-1),
        accumulate=True)[:S]
    ok = card > 0
    voting = torch.where(ok, vsum / card.clamp_min(1), 0.0)
    traj_row = torch.arange(T, dtype=torch.int32,
                            device=dev).repeat_interleave(max_subs)
    return SubtrajTable(t_start=torch.where(ok, t_start, 0.0),
                        t_end=torch.where(ok, t_end, 0.0), voting=voting,
                        card=card, valid=ok, traj_row=traj_row)


def finalize_sim(raw: torch.Tensor, table: SubtrajTable) -> torch.Tensor:
    """Eq. 2 normalization of the raw ``[S, S]`` scatter, symmetrized and
    masked.  ``raw`` is overwritten (it holds the normalized matrix
    afterwards): at full size each ``[S, S]`` temporary is 4.3 GB."""
    S = table.num_slots
    card = table.card
    for r0 in range(0, S, ROW_CHUNK):
        r = slice(r0, r0 + ROW_CHUNK)
        denom = torch.minimum(card[r, None], card[None, :]).clamp_min(1)
        raw[r] /= denom.to(torch.float32)
    sim = torch.maximum(raw, raw.T)
    idx = torch.arange(S, device=raw.device)
    for r0 in range(0, S, ROW_CHUNK):
        r = slice(r0, r0 + ROW_CHUNK)
        keep = (table.valid[r, None] & table.valid[None, :]
                & (idx[r, None] != idx[None, :]))
        sim[r].masked_fill_(~keep, 0.0)
    return sim


def scatter_operands(join: JoinResult, ref_seg: SubtrajSegmentation,
                     cand_seg_sub_local: torch.Tensor, S: int,
                     max_subs: int, rows: slice = slice(None)):
    """Flat SP-scatter contributions ``(src [N], dst [N], w [N])`` of the
    reference rows ``rows``, in (t, m, c) order; ``S`` is the sentinel for
    unmatched / unsegmented points."""
    T, M, C = join.best_w.shape
    dev = join.best_w.device
    t_ids = torch.arange(T, device=dev)[rows]
    sub = ref_seg.sub_local[rows]
    src = torch.where(sub >= 0, t_ids[:, None] * max_subs + sub, S)
    best_idx = join.best_idx[rows]
    src = src[:, :, None].expand(best_idx.shape)
    idx = best_idx.clamp(0, cand_seg_sub_local.shape[1] - 1).long()
    c_ids = torch.arange(C, device=dev)
    cand_sub = cand_seg_sub_local[c_ids[None, None, :], idx]
    dst = torch.where((best_idx >= 0) & (cand_sub >= 0),
                      c_ids * max_subs + cand_sub, S)
    return src.reshape(-1), dst.reshape(-1), join.best_w[rows].reshape(-1)


def similarity_matrix(join: JoinResult, ref_seg: SubtrajSegmentation,
                      cand_seg_sub_local: torch.Tensor, table: SubtrajTable,
                      max_subs: int) -> torch.Tensor:
    """Densified SP relation: Sim[S, S] per Eq. 2, symmetrized.

    The scatter runs in chunks of reference trajectories, in the flat
    (t, m, c) order.  Contributions that land on the sentinel row or
    column, or weigh 0, are dropped before the scatter: the sentinel
    cells are discarded, and adding +0.0 to a non-negative sum changes no
    bit, so every kept cell sees the same additions in the same order.
    """
    S = table.num_slots
    T, M, C = join.best_w.shape
    raw = torch.zeros((S, S), dtype=torch.float32, device=join.best_w.device)
    flat = raw.view(-1)
    rows = max(1, SCATTER_ELEMENTS // max(M * C, 1))
    for t0 in range(0, T, rows):
        src, dst, w = scatter_operands(join, ref_seg, cand_seg_sub_local, S,
                                       max_subs, slice(t0, t0 + rows))
        keep = (src < S) & (dst < S) & (w != 0.0)
        lin = src[keep] * S + dst[keep]
        flat.index_put_((lin,), w[keep], accumulate=True)
    return finalize_sim(raw, table)


def _row_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 along a fixed pairwise tree (zero-padded to a power
    of two): the association order depends only on the row length."""
    n = x.shape[1]
    p = 1 << max(n - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def sim_row_moments(sim_rows: torch.Tensor, row_valid: torch.Tensor,
                    col_valid: torch.Tensor):
    """Per-row (count, sum, sum-of-squares) of the positive entries: the
    sufficient statistics of alpha.  Strictly row-wise along the fixed
    tree, so row chunks give bit-identical per-row results."""
    out = ([], [], [])
    for r0 in range(0, sim_rows.shape[0], ROW_CHUNK):
        r = slice(r0, r0 + ROW_CHUNK)
        pos = ((sim_rows[r] > 0.0) & row_valid[r, None]
               & col_valid[None, :])
        x = torch.where(pos, sim_rows[r], 0.0)
        out[0].append(_row_tree_sum(pos.to(torch.int32)))
        out[1].append(_row_tree_sum(x))
        out[2].append(_row_tree_sum(x * x))
    return tuple(torch.cat(o) for o in out)
