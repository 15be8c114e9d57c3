"""Subtrajectory similarity (Eq. 2) and the ST / SP relations
(counterpart of ``repro.core.similarity`` on one host, with the
canonical list merges ``sort_topk_lists`` / ``merge_topk_lists`` that the
streaming service reads, and the column-block pieces of the multi-device
program, ``merge_topk_blocks`` and ``finalize_sim_cols``).

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
from repro_torch.kernels.cluster.ref import sim_row_moments_ref

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


def scatter_operands(join: JoinResult, ref_seg: SubtrajSegmentation,
                     cand_seg_sub_local: torch.Tensor, S: int,
                     max_subs: int):
    """Flat SP-scatter contribution list ``(src [N], dst [N], w [N])``,
    ``N = T*M*C`` in (t, m, c) order: ``src`` / ``dst`` are subtrajectory
    slots with ``S`` as the sentinel for unmatched / unsegmented points
    (the reference's list, entry for entry).  The public surface of
    :func:`contribution_panel_raw`; the pipeline's own paths never build
    the list (at dsc_brest it is 2.1e9 entries)."""
    T, M, C = join.best_w.shape
    dev = join.best_w.device
    src = slot_ids(ref_seg.sub_local, max_subs, S)                 # [T, M]
    src = src[:, :, None].expand(T, M, C)
    c = torch.arange(C, dtype=torch.int32, device=dev)[None, None, :]
    idx = join.best_idx.clamp(0, cand_seg_sub_local.shape[1] - 1).long()
    cand_sub = cand_seg_sub_local[c.long(), idx]                   # [T, M, C]
    dst = torch.where((join.best_idx >= 0) & (cand_sub >= 0),
                      c * max_subs + cand_sub, S)
    return (src.reshape(-1).to(torch.int32), dst.reshape(-1).to(torch.int32),
            join.best_w.reshape(-1))


def _ordered_add(flat: torch.Tensor, cell: torch.Tensor, w: torch.Tensor):
    """``flat[cell[i]] += w[i]`` for every i, each cell adding in ``i``
    order: one ``index_put_`` per occurrence rank (the first entry of
    every cell, then the second, ...), so no index repeats within a call
    (the card's ``index_put_(accumulate=True)`` reorders repeated
    indices).  On a DSC list the ranks are the point positions m, as in
    ``scatter_raw``."""
    if cell.numel() == 0:
        return
    key, order = torch.sort(cell, stable=True)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    pos = torch.arange(key.numel(), device=key.device)
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        flat.index_put_((cell[sel],), w[sel], accumulate=True)


def contribution_panel_raw(src: torch.Tensor, dst: torch.Tensor,
                           w: torch.Tensor, S: int, Sb: int):
    """``panel_raw(p0)`` closure over a flat contribution list (the
    reference's contract, from :func:`scatter_operands`): the entries
    whose ``src`` (fwd) / ``dst`` (rev) falls inside the panel ``[p0, p0
    + Sb)``, scattered in both orientations into ``[Sb, S]`` slabs; the
    sentinel ``S`` and the other panels' entries are dropped.  Each cell
    adds its entries in the list's order (``_ordered_add``), so the slabs
    equal the cube closure's bit for bit."""
    src, dst = src.long(), dst.long()

    def panel_raw(p0):
        slabs = []
        for own, other in ((src, dst), (dst, src)):
            keep = (own >= p0) & (own < p0 + Sb) & (other < S) & (w > 0.0)
            slab = torch.zeros((Sb, S), dtype=torch.float32, device=w.device)
            _ordered_add(slab.view(-1), (own[keep] - p0) * S + other[keep],
                         w[keep])
            slabs.append(slab)
        return tuple(slabs)

    return panel_raw


def similarity_scatter(join: JoinResult, ref_seg: SubtrajSegmentation,
                       cand_seg_sub_local: torch.Tensor, table: SubtrajTable,
                       max_subs: int) -> torch.Tensor:
    """The cube's raw SP scatter ``[S, C * max_subs]``, before
    ``finalize_sim``."""
    S = table.num_slots
    n_dst = cand_seg_sub_local.shape[0] * max_subs
    return scatter_raw(join.best_w, join.best_idx,
                       slot_ids(ref_seg.sub_local, max_subs, S),
                       slot_ids(cand_seg_sub_local, max_subs, n_dst), S,
                       n_dst)


def similarity_matrix(join: JoinResult, ref_seg: SubtrajSegmentation,
                      cand_seg_sub_local: torch.Tensor, table: SubtrajTable,
                      max_subs: int) -> torch.Tensor:
    """Densified SP relation: Sim[S, S] per Eq. 2, symmetrized."""
    return finalize_sim(similarity_scatter(join, ref_seg, cand_seg_sub_local,
                                           table, max_subs), table)


def sim_row_moments(sim_rows: torch.Tensor, row_valid: torch.Tensor,
                    col_valid: torch.Tensor, *, use_kernel: bool = False):
    """Per-row (count, sum, sum-of-squares) of the positive entries: the
    sufficient statistics of alpha.  Strictly row-wise along a fixed
    pairwise tree (``kernels.cluster.ref.sim_row_moments_ref``), so row
    panels give bit-identical per-row results.  ``use_kernel=True`` runs
    it through the CUDA kernel (``kernels.cluster.ops.sim_row_moments``,
    bitwise the tree) on CUDA tensors."""
    if use_kernel:
        from repro_torch.kernels.cluster.ops import sim_row_moments as k16
        return k16(sim_rows, row_valid, col_valid)
    return sim_row_moments_ref(sim_rows, row_valid, col_valid)


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
                       table: SubtrajTable,
                       active: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 2 finalization of one row panel from its two raw orientations.

    ``fwd[i, j] = raw[p0 + i, j]`` and ``rev[i, j] = raw[j, p0 + i]``, so
    ``max(fwd, rev)`` is the panel's rows of ``max(raw, raw.T)``.  The
    symmetric ``min(card)`` denominator commutes with the max (IEEE
    division by a positive number is monotone), so dividing after the max
    is bit-identical to ``finalize_sim``'s divide-then-max.  ``active``
    (the multi-device program) also masks rows and columns to the
    partition's active slots.
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
    if active is not None:
        keep &= active[r, None] & active[None, :]
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
                panel: int | None = None,
                active: torch.Tensor | None = None,
                use_kernel: bool = False) -> TopKSim:
    """Drive the panel sweep: raw orientations -> finalize -> top-K.

    ``panel_raw_fn(p0)`` returns the two raw orientations ``(fwd [Sb, S],
    rev [Sb, S])`` of the rows ``[p0, p0 + Sb)``: from the join cube
    (``_cube_panel_raw``, or ``contribution_panel_raw`` over the flat
    list of ``scatter_operands``) or from the fused panel pass
    (``kernels.stjoin.ops.stjoin_sim_panel_fused``, K7).  A Python loop
    over the panels writes each panel's ``[Sb, K]`` reduction into the
    ``[S, K]`` lists; only one panel's slabs are live at a time.
    ``active`` masks rows and columns as in ``finalize_sim_panel``;
    ``use_kernel`` as in ``sim_row_moments``.
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
        sim_rows = finalize_sim_panel(*panel_raw_fn(p0), p0, table,
                                      active=active)
        degree[r], row_sum[r], row_sumsq[r] = sim_row_moments(
            sim_rows, table.valid[r], table.valid, use_kernel=use_kernel)
        ids[r], sims[r], spill[r] = topk_reduce_rows(sim_rows, k)
        del sim_rows
    return TopKSim(ids=ids, sims=sims, spill=spill, degree=degree,
                   row_sum=row_sum, row_sumsq=row_sumsq)


def _cube_panel_raw(best_w: torch.Tensor, best_idx: torch.Tensor,
                    ref_gid: torch.Tensor, cand_gid: torch.Tensor,
                    S: int, Sb: int):
    """``panel_raw(p0)`` closure over the join cube ``[T, M, C]`` (slot
    maps ``ref_gid [T, M]``, ``cand_gid [C, Mc]``, sentinel ``S``): the
    slabs of :func:`contribution_panel_raw` without the flat list.

    The forward slab scatters only the cube's rows that own a slot of the
    panel, the reverse slab only its candidates that do, each through the
    ordered ``scatter_raw``, so every cell adds the same weights in the
    same (t, m, c) order as the dense matrix, and no panel touches the
    rest of the cube.  (The flat list holds all ``T*M*C`` contributions:
    2.1e9 entries at dsc_brest.)
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
                    panel: int | None = None,
                    use_kernel: bool = False) -> TopKSim:
    """Sparse SP relation from a materialized join: the panel-streamed
    counterpart of ``similarity_matrix`` (same cells, bit for bit), with
    no ``[S, S]`` tensor (``use_kernel`` as in ``topk_stream``)."""
    S = table.num_slots
    Sb = plan_panel(S, panel)
    fn = _cube_panel_raw(
        join.best_w, join.best_idx, slot_ids(ref_seg.sub_local, max_subs, S),
        slot_ids(cand_seg_sub_local, max_subs, S), S, Sb)
    return topk_stream(fn, table, k=k, panel=Sb, use_kernel=use_kernel)


def topk_from_dense(sim: torch.Tensor, table: SubtrajTable, k: int,
                    active: torch.Tensor | None = None) -> TopKSim:
    """TopKSim of a finalized dense matrix (tests and oracles): bitwise
    what the panel sweep gives for the same cells.  Rows are reduced in
    chunks of ``ROW_CHUNK``, so the sort's temporaries stay bounded.
    ``active`` masks rows and columns to the partition's active slots
    (and the moments to its valid ones), as the panel sweep does."""
    S = table.num_slots
    k = min(k, S)
    valid = table.valid
    if active is not None:
        valid = valid & active
        sim = torch.where(active[:, None] & active[None, :], sim, 0.0)
    cnt, rsum, rsumsq = sim_row_moments(sim, valid, valid)
    parts = [topk_reduce_rows(sim[r0:r0 + ROW_CHUNK], k)
             for r0 in range(0, S, ROW_CHUNK)]
    ids, sims, spill = (torch.cat(p) for p in zip(*parts))
    return TopKSim(ids=ids, sims=sims, spill=spill, degree=cnt,
                   row_sum=rsum, row_sumsq=rsumsq)


def sort_topk_lists(ids: torch.Tensor, sims: torch.Tensor, kk: int):
    """Canonical top-``kk`` of candidate lists: rows sorted by the total
    order (sim descending, id ascending), then truncated.

    The order makes the result a function of the *set* of ``(id, sim)``
    pairs of a row alone (ids distinct within a row), whatever their
    column order or grouping.  The reference sorts on both keys at once
    (``lax.sort(num_keys=2)``); torch has no multi-key sort, so a stable
    sort by id, then a stable descending sort by sim, gives the same
    order.  Neither sort tells ``-0.0`` from ``+0.0`` (equal values keep
    the id order), as ``lax.sort`` does not either.

    ``sims`` are similarity values (non-negative); returns ``(ids [S,
    kk], sims [S, kk])`` untruncated by sign — masking to ``(id=-1,
    sim=0)`` stays with the caller.
    """
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    ids_s = torch.gather(ids, -1, by_id)
    sims_s = torch.gather(sims, -1, by_id)
    by_sim = torch.sort(sims_s, dim=-1, descending=True, stable=True).indices
    kk = min(kk, sims.shape[-1])
    by_sim = by_sim[..., :kk]
    return torch.gather(ids_s, -1, by_sim), torch.gather(sims_s, -1, by_sim)


def merge_topk_lists(ids_a, sims_a, ids_b, sims_b, kk: int):
    """Pairwise canonical merge: fold the list ``b`` into the standing
    top-``kk`` ``a``.  Exact because the top-``kk`` of a union lies in the
    union of the operands' top-``kk`` lists, and canonical because
    ``sort_topk_lists`` is."""
    return sort_topk_lists(torch.cat([ids_a, ids_b], dim=1),
                           torch.cat([sims_a, sims_b], dim=1), kk)


def topk_overflow(topk: TopKSim, alpha) -> torch.Tensor:
    """Rows whose spill certificate fails (int32 count): the largest
    similarity K cut off is itself a potential alpha-edge.  0 proves the
    top-K labels equal the dense ones."""
    over = (topk.spill > 0.0) & (topk.spill >= alpha)
    return over.sum().to(torch.int32)


def merge_topk_blocks(ids: torch.Tensor, sims: torch.Tensor, k: int):
    """K-way merge of per-block top-(K+1) lists into the global top-K and
    the spill certificate: ``(ids [S, k], sims [S, k], spill [S])``.

    ``ids [S, B*(K+1)]`` / ``sims`` concatenate the blocks' lists
    (disjoint column ranges, exact values).  A row's global top-(K+1)
    lies in the union of its blocks' top-(K+1) lists, so the merged top-K
    and (K+1)-th value are those of the full row, in the canonical
    (sim desc, id asc) order of ``sort_topk_lists``.
    """
    mi, ms = sort_topk_lists(ids, sims, min(k + 1, sims.shape[1]))
    return _topk_tail(ms, mi, k)


def finalize_sim_cols(sym_blk: torch.Tensor, c0: int, table: SubtrajTable,
                      active: torch.Tensor | None = None) -> torch.Tensor:
    """Eq. 2 finalization of a symmetrized *column block* ``[S, S_loc]``:
    ``sym_blk[i, j] = max(raw[i, c0+j], raw[c0+j, i])``.  Masks and
    normalization mirror ``finalize_sim`` cell for cell (``active``:
    rows and columns outside the partition's active slots are 0)."""
    S, S_loc = sym_blk.shape
    dev = sym_blk.device
    rows = torch.arange(S, device=dev)
    cols = torch.arange(c0, c0 + S_loc, device=dev)
    c = slice(c0, c0 + S_loc)
    out = torch.empty_like(sym_blk)
    for r0 in range(0, S, ROW_CHUNK):
        r = slice(r0, r0 + ROW_CHUNK)
        denom = torch.minimum(table.card[r, None], table.card[None, c])
        sim = sym_blk[r] / denom.clamp_min(1).to(torch.float32)
        keep = (table.valid[r, None] & table.valid[None, c]
                & (rows[r, None] != cols[None, :]))
        if active is not None:
            keep &= active[r, None] & active[None, c]
        out[r] = torch.where(keep, sim, 0.0)
    return out
