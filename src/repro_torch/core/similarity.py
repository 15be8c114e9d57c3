"""Subtrajectory similarity (Eq. 2) and the ST / SP relations
(counterpart of ``repro.core.similarity`` on one host; the distributed
list merges ``sort_topk_lists`` / ``merge_topk_*`` and
``finalize_sim_cols`` are ROADMAP queue 1 item 9).

Every join match ``(ref point (r, m) <-> best point of candidate c)``
adds its weight ``1 - d_s/eps_sp`` to the (sub(r, m), sub(c, best_idx))
cell of the ``[S, S]`` matrix; Eq. 2 divides by ``min(|r'|, |s'|)`` and
the matrix is max-symmetrized (DESIGN.md §2.4).

Two representations (DESIGN.md §8):

* dense ``[S, S]`` — ``similarity_matrix`` / ``finalize_sim``;
* top-K neighbor lists — ``similarity_topk`` / ``topk_stream``: the matrix
  is swept in row panels of ``Sb`` slots.  Each panel gets its rows of
  ``raw`` and of ``raw.T`` (``fwd``, ``rev``), is normalized, reduced to
  ``[Sb, K]`` lists and per-row moments, and dropped, so no ``[S, S]``
  tensor ever exists.

The order of the float additions into a cell is the reference's flat
(t, m, c) order on every backend, never a float atomic: ``scatter_raw``
runs one ``index_put_(accumulate=True)`` per point position m, and no
index repeats within one call.  (The card's ``index_put_`` sorts its
indices and does not keep repeated ones in their original order, so one
call over several m would sum a cell in another order there.)  The fused
passes (``kernels.stjoin``, K4 and the panel pass K7) add in the same
order, so both modes and both representations see the same cells bit for
bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import (JoinResult, SubtrajSegmentation,
                                    SubtrajTable, TopKSim, TrajectoryBatch)

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
                n_dst: int, *, transpose: bool = False) -> torch.Tensor:
    """The un-normalized SP scatter ``raw [n_src, n_dst]``:
    ``raw[ref_gid[t, m], cand_gid[c, best_idx[t, m, c]]] += best_w[t, m, c]``
    over every match of the join ``[T, M, C]``; ``transpose=True`` builds
    ``raw.T [n_dst, n_src]`` instead, in the same order.

    ``ref_gid [T, M]`` (``n_src`` = sentinel), ``cand_gid [C, Mc]``
    (``n_dst`` = sentinel).  One ``index_put_`` per m, in ascending m:
    with the DSC slot maps a cell belongs to one (t, c) pair, so no index
    repeats within one call and each cell adds in (t, m, c) order.
    Sentinel and zero-weight contributions are dropped (adding +0.0 to a
    non-negative sum changes no bit).
    """
    T, M, C = best_w.shape
    dev = best_w.device
    shape = (n_dst, n_src) if transpose else (n_src, n_dst)
    raw = torch.zeros(shape, dtype=torch.float32, device=dev)
    flat = raw.view(-1)
    c_ids = torch.arange(C, device=dev)[None, :]
    for m in range(M):
        wm, im = best_w[:, m], best_idx[:, m]
        src = ref_gid[:, m, None].long().expand(T, C)
        dst = cand_gid[c_ids, im.clamp_min(0).long()].long()
        keep = (wm > 0.0) & (im >= 0) & (src < n_src) & (dst < n_dst)
        src, dst = src[keep], dst[keep]
        cell = dst * n_src + src if transpose else src * n_dst + dst
        flat.index_put_((cell,), wm[keep], accumulate=True)
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


# ---------------------------------------------------------------------------
# Panel-streamed top-K engine (DESIGN.md §8): the sparse SP representation.
# ---------------------------------------------------------------------------


def largest_divisor(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target``."""
    for b in range(min(n, max(target, 1)), 0, -1):
        if n % b == 0:
            return b
    return 1


def plan_panel(S: int, target: int | None = None) -> int:
    """Panel height ``Sb``: the largest divisor of ``S`` at most ``target``
    (default 128), so every panel is full."""
    return largest_divisor(S, target if target is not None else 128)


def panel_members(gid: torch.Tensor, p0: int, Sb: int) -> torch.Tensor:
    """Rows of a slot map ``gid [R, M]`` that own a slot of the panel
    ``[p0, p0 + Sb)``: the only rows whose matches reach its cells."""
    meets = ((gid >= p0) & (gid < p0 + Sb)).any(dim=1)
    return torch.nonzero(meets)[:, 0]


def panel_local(gid: torch.Tensor, p0: int, Sb: int) -> torch.Tensor:
    """A slot map made panel-local: ``gid - p0`` inside the panel, the
    sentinel ``Sb`` everywhere else."""
    return torch.where((gid >= p0) & (gid < p0 + Sb), gid - p0, Sb)


def finalize_sim_panel(fwd: torch.Tensor, rev: torch.Tensor, p0: int,
                       table: SubtrajTable) -> torch.Tensor:
    """Eq. 2 finalization of one row panel from its two raw orientations.

    ``fwd[i, j] = raw[p0 + i, j]`` and ``rev[i, j] = raw[j, p0 + i]``, so
    ``max(fwd, rev)`` is the panel's rows of ``max(raw, raw.T)``.  The
    symmetric ``min(card)`` denominator commutes with the max (IEEE
    division by a positive number is monotone), so dividing after the max
    is bit-identical to ``finalize_sim``'s divide-then-max.
    """
    Sb, S = fwd.shape
    dev = fwd.device
    r = slice(p0, p0 + Sb)
    rows = torch.arange(p0, p0 + Sb, device=dev)
    cols = torch.arange(S, device=dev)
    denom = torch.minimum(table.card[r, None], table.card[None, :])
    sim = torch.maximum(fwd, rev) / denom.clamp_min(1).to(torch.float32)
    keep = (table.valid[r, None] & table.valid[None, :]
            & (rows[:, None] != cols[None, :]))
    return torch.where(keep, sim, 0.0)


def _topk_tail(vals: torch.Tensor, cand_ids: torch.Tensor, k: int):
    """Truncate the top-(K+1) ``(vals, candidate ids)`` of each row to the
    K retained edges (id -1 / sim 0 where not positive) and the spill
    certificate: the (K+1)-th value, clamped at 0, 0 where it does not
    exist."""
    sims = vals[:, :k]
    ids = torch.where(sims > 0.0, cand_ids[:, :k], -1).to(torch.int32)
    sims = sims.clamp_min(0.0)
    if vals.shape[1] > k:
        spill = vals[:, k].clamp_min(0.0)
    else:
        spill = torch.zeros((vals.shape[0],), dtype=torch.float32,
                            device=vals.device)
    return ids, sims, spill


def topk_reduce_rows(sim_rows: torch.Tensor, k: int):
    """``(ids [R, k], sims [R, k], spill [R])``: the K largest entries of
    each row, descending, ties by ascending column, non-positive entries
    masked to ``(id=-1, sim=0)``, and the (K+1)-th largest value as the
    spill certificate.

    ``lax.top_k`` breaks ties by ascending column; ``torch.topk`` makes no
    such promise.  A stable descending sort keeps equal values in their
    original (ascending column) order by definition, so the port sorts
    whole rows with ``stable=True`` and cuts the first K + 1.
    """
    kk = min(k + 1, sim_rows.shape[1])
    vals, idx = torch.sort(sim_rows, dim=1, descending=True, stable=True)
    return _topk_tail(vals[:, :kk], idx[:, :kk], k)


def topk_stream(panel_raw_fn, table: SubtrajTable, *, k: int,
                panel: int | None = None) -> TopKSim:
    """Drive the panel sweep: raw orientations -> finalize -> top-K.

    ``panel_raw_fn(p0)`` returns the two raw orientations ``(fwd [Sb, S],
    rev [Sb, S])`` of the rows ``[p0, p0 + Sb)``: from the join cube
    (``contribution_panel_raw``) or from the fused panel pass
    (``kernels.stjoin.ops.stjoin_sim_panel_fused``, K7).  A Python loop
    over the panels writes each panel's ``[Sb, K]`` reduction into the
    ``[S, K]`` lists; only one panel's slabs are live at a time.
    """
    S = table.num_slots
    k = min(k, S)
    Sb = plan_panel(S, panel)
    dev = table.valid.device
    ids = torch.empty((S, k), dtype=torch.int32, device=dev)
    sims = torch.empty((S, k), dtype=torch.float32, device=dev)
    spill = torch.empty((S,), dtype=torch.float32, device=dev)
    degree = torch.empty((S,), dtype=torch.int32, device=dev)
    row_sum = torch.empty((S,), dtype=torch.float32, device=dev)
    row_sumsq = torch.empty((S,), dtype=torch.float32, device=dev)
    for p0 in range(0, S, Sb):
        r = slice(p0, p0 + Sb)
        sim_rows = finalize_sim_panel(*panel_raw_fn(p0), p0, table)
        degree[r], row_sum[r], row_sumsq[r] = sim_row_moments(
            sim_rows, table.valid[r], table.valid)
        ids[r], sims[r], spill[r] = topk_reduce_rows(sim_rows, k)
        del sim_rows
    return TopKSim(ids=ids, sims=sims, spill=spill, degree=degree,
                   row_sum=row_sum, row_sumsq=row_sumsq)


def contribution_panel_raw(best_w: torch.Tensor, best_idx: torch.Tensor,
                           ref_gid: torch.Tensor, cand_gid: torch.Tensor,
                           S: int, Sb: int):
    """``panel_raw(p0)`` closure over the join cube ``[T, M, C]`` (slot
    maps ``ref_gid [T, M]``, ``cand_gid [C, Mc]``, sentinel ``S``).

    The forward slab scatters only the cube's rows that own a slot of the
    panel, the reverse slab only its candidates that do, each through the
    ordered ``scatter_raw``, so every cell adds the same weights in the
    same (t, m, c) order as the dense matrix, and no panel touches the
    rest of the cube.  (The reference's closure takes the flat list of all
    ``T*M*C`` contributions and masks it once per panel.)
    """
    def panel_raw(p0):
        rows = panel_members(ref_gid, p0, Sb)
        fwd = scatter_raw(best_w[rows], best_idx[rows],
                          panel_local(ref_gid[rows], p0, Sb), cand_gid, Sb,
                          S)
        cols = panel_members(cand_gid, p0, Sb)
        rev = scatter_raw(best_w[:, :, cols], best_idx[:, :, cols], ref_gid,
                          panel_local(cand_gid[cols], p0, Sb), S, Sb,
                          transpose=True)
        return fwd, rev

    return panel_raw


def similarity_topk(join: JoinResult, ref_seg: SubtrajSegmentation,
                    cand_seg_sub_local: torch.Tensor, table: SubtrajTable,
                    max_subs: int, *, k: int,
                    panel: int | None = None) -> TopKSim:
    """Sparse SP relation from a materialized join: the panel-streamed
    counterpart of ``similarity_matrix`` (same cells, bit for bit), with
    no ``[S, S]`` tensor."""
    S = table.num_slots
    Sb = plan_panel(S, panel)
    fn = contribution_panel_raw(
        join.best_w, join.best_idx, slot_ids(ref_seg.sub_local, max_subs, S),
        slot_ids(cand_seg_sub_local, max_subs, S), S, Sb)
    return topk_stream(fn, table, k=k, panel=Sb)


def topk_from_dense(sim: torch.Tensor, table: SubtrajTable,
                    k: int) -> TopKSim:
    """TopKSim of a finalized dense matrix (tests and oracles): bitwise
    what the panel sweep gives for the same cells.  Rows are reduced in
    chunks of ``ROW_CHUNK``, so the sort's temporaries stay bounded."""
    S = table.num_slots
    k = min(k, S)
    cnt, rsum, rsumsq = sim_row_moments(sim, table.valid, table.valid)
    parts = [topk_reduce_rows(sim[r0:r0 + ROW_CHUNK], k)
             for r0 in range(0, S, ROW_CHUNK)]
    ids, sims, spill = (torch.cat(p) for p in zip(*parts))
    return TopKSim(ids=ids, sims=sims, spill=spill, degree=cnt,
                   row_sum=rsum, row_sumsq=rsumsq)


def topk_overflow(topk: TopKSim, alpha) -> torch.Tensor:
    """Rows whose spill certificate fails (int32 count): the largest
    similarity K cut off is itself a potential alpha-edge.  0 proves the
    top-K labels equal the dense ones."""
    over = (topk.spill > 0.0) & (topk.spill >= alpha)
    return over.sum().to(torch.int32)
