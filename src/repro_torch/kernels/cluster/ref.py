"""Plain PyTorch versions of the two clustering kernels (counterpart of
``repro.kernels.cluster.ref``): the entire per-iteration work of the
round-parallel engine (``core.clustering.cluster_rounds``)."""
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
