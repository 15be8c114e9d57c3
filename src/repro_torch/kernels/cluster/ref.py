"""Plain PyTorch versions of the clustering kernels (counterpart of
``repro.kernels.cluster.ref``): the entire per-iteration work of the
round-parallel engines, on the dense ``[S, S]`` matrix
(``core.clustering.cluster_rounds``) and on ``[S, K]`` neighbor lists
(``core.clustering.cluster_rounds_topk``)."""
from __future__ import annotations

import torch

from repro_torch.core.types import f32

# K5's schedule (csrc/dsc_kernels.cu, round_scan_kernel): threads a block,
# columns a thread, rows staged a pass, rows loaded before their tests
SCAN_THREADS, SCAN_GROUP, SCAN_CHUNK, SCAN_UNROLL = 128, 4, 1024, 4
# K9's (topk_claim_max_kernel): entries a group, lanes a row at most
CLAIM_GROUP, CLAIM_LANES = 4, 32
# K6's (claim_max_kernel): listed representative rows a slice at least
CLAIM_SPLIT_ROWS = 32


def round_scan_ref(sim, rank, unresolved, is_rep, alpha):
    """One round's eligibility scan over the full matrix.

    ``blocked[s]``: an unresolved earlier-visited slot has an alpha-edge
    to ``s`` (``sim[u, s] > 0`` and ``>= alpha`` with ``rank[u] <
    rank[s]``).  ``claimed[s]``: a resolved representative claims ``s``.
    """
    pred = (sim > 0.0) & (sim >= alpha) & (rank[:, None] < rank[None, :])
    blocked = (pred & unresolved[:, None]).any(dim=0)
    claimed = (pred & is_rep[:, None]).any(dim=0)
    return blocked, claimed


def round_scan_schedule_ref(sim, rank, unresolved, is_rep, alpha,
                            n_split: int):
    """K5's schedule, plainly (the kernel's mirror; ``round_scan_ref`` is the
    contract): ``n_split`` row slices of ``ceil(S / n_split)`` rows, each
    staged ``SCAN_CHUNK`` rows at a time and compacted to its active rows
    (either flag set) in row order as ``(u << 2 | flags, rank[u])``; the
    list is read ``SCAN_UNROLL`` rows at a time, then a row at a time for
    the tail, over groups of ``SCAN_GROUP`` columns, the last group cut at
    ``S`` (its missing columns read 0: no edge).  Returns ``(blocked,
    claimed)``, each OR-ed from bit 0 / bit 1 of the listed flags."""
    S = sim.shape[0]
    dev = sim.device
    G = -(-S // SCAN_GROUP)
    pad = G * SCAN_GROUP - S
    low = torch.full((pad,), torch.iinfo(torch.int32).min, dtype=torch.int32,
                     device=dev)
    rs = torch.cat([rank.to(torch.int32), low]).view(G, SCAN_GROUP)
    alpha = f32(alpha, dev)
    flags = unresolved.to(torch.int32) | (is_rep.to(torch.int32) << 1)
    hit = torch.zeros((2, G, SCAN_GROUP), dtype=torch.bool, device=dev)
    rows = -(-S // n_split)
    for u0 in range(0, S, rows):
        u1 = min(S, u0 + rows)
        for base in range(u0, u1, SCAN_CHUNK):
            f = flags[base:min(base + SCAN_CHUNK, u1)]
            listed = torch.nonzero(f).flatten()
            uf = ((base + listed).to(torch.int32) << 2) | f[listed]
            rk = rank[(uf >> 2).long()].to(torch.int32)
            n = uf.shape[0]
            whole = n - n % SCAN_UNROLL
            steps = [(k, SCAN_UNROLL) for k in range(0, whole, SCAN_UNROLL)]
            steps += [(k, 1) for k in range(whole, n)]
            for k, width in steps:
                uk = uf[k:k + width]
                v = torch.nn.functional.pad(sim[(uk >> 2).long()], (0, pad))
                v = v.view(width, G, SCAN_GROUP)
                pred = ((v > 0.0) & (v >= alpha)
                        & (rk[k:k + width, None, None] < rs))
                for bit in range(2):
                    fk = ((uk[:, None, None] >> bit) & 1).bool()
                    hit[bit] |= (pred & fk).any(0)
    return hit[0].flatten()[:S], hit[1].flatten()[:S]


def claim_max_ref(sim, order, rank, is_rep, valid, alpha):
    """Final membership claim-max: per column ``s``, the representative
    row of maximum similarity, minimum rank winning ties.  Returns
    ``(best_w [S] f32, best_slot [S] i32)``; ``(0.0, -1)`` where no
    representative claims the column.  The counterpart of the reference's
    ``claim_max_ref``, whose ``order`` (the visit order, ``rank``'s
    inverse) names the winning rank's row; ``cluster_assign_ref`` finds
    that row without it, for any int32 ``rank``, so ``order`` goes
    unused."""
    return cluster_assign_ref(sim, rank, is_rep, valid, alpha)


def cluster_assign_ref(sim, rank, is_rep, valid, alpha):
    """K6's plain twin, for any int32 ``rank`` (duplicates included): per
    valid column, over the representative rows with an alpha-edge to it,
    the maximum weight, then the minimum rank among those rows, then the
    lowest row of that rank; ``(0.0, -1)`` where no representative claims
    the column.  The reference's ``_assign_kernel`` orders the candidates
    the same way (strict ``<`` across row blocks, ``argmin`` within one),
    except for a candidate of rank 2^31 - 1, its sentinel for "no
    candidate", where its ``argmin`` may name a row that is not one."""
    S = sim.shape[0]
    dev = sim.device
    rows = torch.nonzero(is_rep).flatten()
    best_w = torch.zeros((S,), dtype=torch.float32, device=dev)
    if rows.numel() == 0:
        return best_w, torch.full((S,), -1, dtype=torch.int32, device=dev)
    s = sim[rows]                                   # [R, S], rows ascending
    claim = valid[None, :] & (s > 0.0) & (s >= f32(alpha, dev))
    w = torch.where(claim, s, 0.0)
    best_w = w.amax(dim=0)
    cand = claim & (w == best_w[None, :])
    rk = rank[rows].to(torch.int32)[:, None]
    best_rank = torch.where(cand, rk, torch.iinfo(torch.int32).max).amin(0)
    at = cand & (rk == best_rank[None, :])
    best_slot = torch.where(at, rows[:, None], S).amin(dim=0)
    return best_w, torch.where(best_w > 0.0, best_slot.to(torch.int32), -1)


def claim_max_schedule_ref(sim, rank, is_rep, valid, alpha, n_split: int):
    """K6's schedule, plainly (the kernel's mirror; ``cluster_assign_ref``
    is the contract): the representative rows listed in row order as
    ``(row, rank)``, the list cut into ``claim_splits(R, n_split)`` slices
    ``[R * y / n, R * (y + 1) / n)``; each slice keeps a running ``(w,
    rank, slot)`` per column, replaced by a listed row with an alpha-edge
    to a valid column and ``w`` greater, or equal with a smaller rank; the
    slices' partials merge in slice order by the same test."""
    S = sim.shape[0]
    dev = sim.device
    rows = torch.nonzero(is_rep).flatten()
    R = rows.numel()
    n = claim_splits(R, n_split)
    alpha = f32(alpha, dev)
    big = torch.iinfo(torch.int32).max

    def empty():
        return (torch.zeros((S,), dtype=torch.float32, device=dev),
                torch.full((S,), big, dtype=torch.int32, device=dev),
                torch.full((S,), -1, dtype=torch.int32, device=dev))

    def fold(acc, w, r, slot):
        aw, ar, aslot = acc
        take = (w > aw) | ((w == aw) & (r < ar))
        return (torch.where(take, w, aw), torch.where(take, r, ar),
                torch.where(take, slot, aslot))

    best = empty()
    for y in range(n):
        part = empty()
        for u in rows[R * y // n:R * (y + 1) // n].tolist():
            v = sim[u]
            ok = valid & (v > 0.0) & (v >= alpha)
            part = fold(part, torch.where(ok, v, 0.0),
                        torch.where(ok, rank[u].to(torch.int32), big),
                        torch.where(ok, u, -1).to(torch.int32))
        best = fold(best, *part)
    best_w = best[0]
    return best_w, torch.where(best_w > 0.0, best[2], -1)


def claim_splits(R: int, n_split: int) -> int:
    """Slices K6 cuts its list of ``R`` representative rows into (its
    kernel's rule): one per ``CLAIM_SPLIT_ROWS`` rows, at least one, at
    most the launcher's ``n_split``.  The card tests hold it against the
    launcher's own count (``claim_max_slices`` of the kernel library)."""
    return max(1, min(n_split, -(-R // CLAIM_SPLIT_ROWS)))


# rows a chunk of the plain moments (bounds their temporaries; the tree is
# strictly row-wise, so any chunking gives the same bits)
MOMENT_ROWS = 4096


def _row_tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 along a fixed pairwise tree (zero-padded to a power
    of two): the association order depends only on the row length."""
    n = x.shape[1]
    p = 1 << max(n - 1, 0).bit_length()
    x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[1] > 1:
        x = x[:, 0::2] + x[:, 1::2]
    return x[:, 0]


def sim_row_moments_ref(sim_rows, row_valid, col_valid):
    """Per-row (count, sum, sum-of-squares) of the entries that are
    positive in a valid row and a valid column: the sufficient statistics
    of alpha, each summed along ``_row_tree_sum``'s tree (the plain
    version of K16; the reference computes the same in plain jnp,
    ``repro.core.similarity.sim_row_moments``)."""
    out = ([], [], [])
    for r0 in range(0, sim_rows.shape[0], MOMENT_ROWS):
        r = slice(r0, r0 + MOMENT_ROWS)
        pos = ((sim_rows[r] > 0.0) & row_valid[r, None]
               & col_valid[None, :])
        x = torch.where(pos, sim_rows[r], 0.0)
        out[0].append(_row_tree_sum(pos.to(torch.int32)))
        out[1].append(_row_tree_sum(x))
        out[2].append(_row_tree_sum(x * x))
    return tuple(torch.cat(o) for o in out)


# Neighbor-list (top-K) variants: row ``s`` of ``ids`` / ``sims`` holds
# ``s``'s retained edges.  The matrix is max-symmetrized, so ``sim[u, s] ==
# sim[s, u]`` and ``s``'s own list carries every edge the dense column scan
# reads; exact whenever the spill certificate holds.


def topk_round_scan_ref(ids, sims, rank, unresolved, is_rep, alpha):
    """One round's eligibility scan over ``[S, K]`` neighbor lists: entry
    ``u = ids[s, e]`` is a predecessor of ``s`` when the edge is an
    alpha-edge and ``rank[u] < rank[s]`` (``round_scan_ref``'s predicate
    read from ``s``'s side)."""
    S = rank.shape[0]
    safe = ids.clamp(0, S - 1).long()
    edge = (ids >= 0) & (sims > 0.0) & (sims >= alpha)
    pred = edge & (rank[safe] < rank[:, None])
    blocked = (pred & unresolved[safe]).any(dim=1)
    claimed = (pred & is_rep[safe]).any(dim=1)
    return blocked, claimed


def topk_claim_max_ref(ids, sims, rank, is_rep, valid, alpha):
    """Final claim-max over ``[S, K]`` neighbor lists: per slot, the
    representative neighbor of maximum similarity, minimum visit rank
    among ties.  ``(best_w [S] f32, best_slot [S] i32)``, ``(0.0, -1)``
    where no representative claims the slot."""
    S = rank.shape[0]
    safe = ids.clamp(0, S - 1).long()
    claim = ((ids >= 0) & valid[:, None] & (sims > 0.0) & (sims >= alpha)
             & is_rep[safe])
    w = torch.where(claim, sims, 0.0)
    best_w = w.amax(dim=1)
    cand = claim & (w == best_w[:, None]) & (best_w[:, None] > 0.0)
    r = torch.where(cand, rank[safe], S)
    e = r.argmin(dim=1)
    best_slot = safe.gather(1, e[:, None])[:, 0].to(torch.int32)
    return best_w, torch.where(best_w > 0.0, best_slot, -1)


def claim_lanes(K: int) -> int:
    """K9's lanes a row (its launcher's rule): the least power of two
    covering the row's ``ceil(K / 4)`` groups, at most 32."""
    G = -(-K // CLAIM_GROUP)
    L = 1
    while L < CLAIM_LANES and L < G:
        L *= 2
    return L


def topk_claim_max_schedule_ref(ids, sims, rank, is_rep, valid, alpha):
    """K9's schedule, plainly (the kernel's mirror; ``topk_claim_max_ref``
    is the contract): ``L = claim_lanes(K)`` lanes a row; lane ``l`` reads
    the groups of 4 entries ``l, l + L, ...`` in order (the last group cut
    at K: the missing entries are padding, id -1) and keeps a running
    ``(w, rank, slot)``, replaced by an entry that is an alpha-edge to a
    representative with ``w`` greater, or equal with a smaller rank; a
    butterfly over the ``L`` lanes (partners ``l ^ L/2, ..., l ^ 1``)
    merges them by the same order.  Invalid rows give ``(0.0, -1)``."""
    S, K = ids.shape
    dev = ids.device
    L = claim_lanes(K)
    G = -(-K // CLAIM_GROUP)
    n = -(-G // L) * L * CLAIM_GROUP - K
    pid = torch.nn.functional.pad(ids, (0, n), value=-1)
    psim = torch.nn.functional.pad(sims, (0, n))
    # [S, rounds, L, 4] -> each lane's entries in its reading order
    lane_ids = pid.view(S, -1, L, CLAIM_GROUP).transpose(1, 2).reshape(
        S, L, -1)
    lane_sims = psim.view(S, -1, L, CLAIM_GROUP).transpose(1, 2).reshape(
        S, L, -1)
    alpha = f32(alpha, dev)
    aw = torch.zeros((S, L), dtype=torch.float32, device=dev)
    ar = torch.full((S, L), torch.iinfo(torch.int32).max, dtype=torch.int32,
                    device=dev)
    slot = torch.full((S, L), -1, dtype=torch.int32, device=dev)
    live = valid[:, None]
    for e in range(lane_ids.shape[2]):
        u, v = lane_ids[:, :, e], lane_sims[:, :, e]
        safe = u.clamp(0, S - 1).long()
        r = rank[safe]
        take = (live & (u >= 0) & (v > 0.0) & (v >= alpha) & is_rep[safe]
                & ((v > aw) | ((v == aw) & (r < ar))))
        aw = torch.where(take, v, aw)
        ar = torch.where(take, r, ar)
        slot = torch.where(take, u, slot)
    off = L // 2
    while off:
        p = torch.arange(L, device=dev) ^ off
        ow, orr, os_ = aw[:, p], ar[:, p], slot[:, p]
        take = (ow > aw) | ((ow == aw) & (orr < ar))
        aw = torch.where(take, ow, aw)
        ar = torch.where(take, orr, ar)
        slot = torch.where(take, os_, slot)
        off //= 2
    best_w = aw[:, 0]
    return best_w, torch.where(best_w > 0.0, slot[:, 0], -1)
