"""Plain PyTorch versions of the clustering kernels (counterpart of
``repro.kernels.cluster.ref``): the entire per-iteration work of the
round-parallel engines, on the dense ``[S, S]`` matrix
(``core.clustering.cluster_rounds``) and on ``[S, K]`` neighbor lists
(``core.clustering.cluster_rounds_topk``)."""
from __future__ import annotations

import torch


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


def claim_max_ref(sim, order, rank, is_rep, valid, alpha):
    """Final membership claim-max: per column ``s``, the representative
    row of maximum similarity, minimum rank winning ties.  Returns
    ``(best_w [S] f32, best_slot [S] i32)``; ``(0.0, -1)`` where no
    representative claims the column."""
    S = sim.shape[0]
    claim = (is_rep[:, None] & valid[None, :] & (sim > 0.0) & (sim >= alpha))
    w = torch.where(claim, sim, 0.0)
    best_w = w.amax(dim=0)
    cand = claim & (w == best_w[None, :])
    r = torch.where(cand, rank[:, None], S)
    best_rank = r.amin(dim=0)
    best_slot = order[best_rank.clamp(0, S - 1)]
    return best_w, torch.where(best_w > 0.0, best_slot, -1)


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
