"""Subtrajectory similarity (Eq. 2) and the ST / SP relations — the dense
representation (counterpart of the dense part of
``repro.core.similarity``; the top-K engine is ROADMAP queue 1 item 7).

Every join match ``(ref point (r, m) <-> best point of candidate c)``
adds its weight ``1 - d_s/eps_sp`` to the (sub(r, m), sub(c, best_idx))
cell of the ``[S, S]`` matrix; Eq. 2 divides by ``min(|r'|, |s'|)`` and
the matrix is max-symmetrized (DESIGN.md §2.4).

The order of the float additions into a cell is the reference's flat
(t, m, c) order on every backend, never a float atomic: ``scatter_raw``
runs one ``index_put_(accumulate=True)`` per point position m, and no
index repeats within one call.  (The card's ``index_put_`` sorts its
indices and does not keep repeated ones in their original order, so one
call over several m would sum a cell in another order there.)  The fused
pass 2 (``kernels.stjoin``, K4) adds in the same order, so both modes
give the same ``[S, S]`` matrix bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import (JoinResult, SubtrajSegmentation,
                                    SubtrajTable, TrajectoryBatch)

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


def slot_ids(sub_local: torch.Tensor, max_subs: int,
             sentinel: int) -> torch.Tensor:
    """Global subtrajectory slot of each point ``[R, M]``:
    ``row * max_subs + sub_local``, ``sentinel`` where unsegmented."""
    rows = torch.arange(sub_local.shape[0], dtype=torch.int32,
                        device=sub_local.device)[:, None]
    return torch.where(sub_local >= 0, rows * max_subs + sub_local, sentinel)


def scatter_raw(best_w: torch.Tensor, best_idx: torch.Tensor,
                ref_gid: torch.Tensor, cand_gid: torch.Tensor, n_src: int,
                n_dst: int) -> torch.Tensor:
    """The un-normalized SP scatter ``raw [n_src, n_dst]``:
    ``raw[ref_gid[t, m], cand_gid[c, best_idx[t, m, c]]] += best_w[t, m, c]``
    over every match of the join ``[T, M, C]``.

    ``ref_gid [T, M]`` (``n_src`` = sentinel), ``cand_gid [C, Mc]``
    (``n_dst`` = sentinel).  One ``index_put_`` per m, in ascending m:
    with the DSC slot maps a cell belongs to one (t, c) pair, so no index
    repeats within one call and each cell adds in (t, m, c) order.
    Sentinel and zero-weight contributions are dropped (adding +0.0 to a
    non-negative sum changes no bit).
    """
    T, M, C = best_w.shape
    dev = best_w.device
    raw = torch.zeros((n_src, n_dst), dtype=torch.float32, device=dev)
    flat = raw.view(-1)
    c_ids = torch.arange(C, device=dev)[None, :]
    for m in range(M):
        wm, im = best_w[:, m], best_idx[:, m]
        src = ref_gid[:, m, None].long().expand(T, C)
        dst = cand_gid[c_ids, im.clamp_min(0).long()].long()
        keep = (wm > 0.0) & (im >= 0) & (src < n_src) & (dst < n_dst)
        flat.index_put_((src[keep] * n_dst + dst[keep],), wm[keep],
                        accumulate=True)
    return raw


def similarity_matrix(join: JoinResult, ref_seg: SubtrajSegmentation,
                      cand_seg_sub_local: torch.Tensor, table: SubtrajTable,
                      max_subs: int) -> torch.Tensor:
    """Densified SP relation: Sim[S, S] per Eq. 2, symmetrized."""
    S = table.num_slots
    n_dst = cand_seg_sub_local.shape[0] * max_subs
    raw = scatter_raw(join.best_w, join.best_idx,
                      slot_ids(ref_seg.sub_local, max_subs, S),
                      slot_ids(cand_seg_sub_local, max_subs, n_dst), S,
                      n_dst)
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
