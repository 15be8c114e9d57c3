"""Voting (Eqs. 4, 5, 6) — counterpart of ``repro.core.voting``.

As in the JAX package, a neighbor votes with the proximity weight
``1 - d_s/eps_sp`` (DESIGN.md §2.1), so a coincident neighbor votes 1.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import JoinResult
from repro_torch.core.windows import pack_bits

# rows of the [T, M, C] cube packed at a time (bounds the int32 widening)
PACK_ROWS = 64


def point_voting(join: JoinResult) -> torch.Tensor:
    """``V(r_i)`` per point: sum of best-match weights over candidates.
    (The sum runs in PyTorch's order, not XLA's: equal to ulps.)"""
    return join.best_w.sum(dim=-1)                            # [T, M] f32


def normalized_voting(vote: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Eq. 5: per-trajectory max-normalized voting vector (0 on padding)."""
    vote = torch.where(valid, vote, 0.0)
    vmax = vote.amax(dim=1, keepdim=True)
    return torch.where(valid, vote / vmax.clamp_min(1e-12), 0.0)


def trajectory_voting(vote: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Eq. 6: mean voting of a trajectory's valid points."""
    n = valid.sum(dim=1).clamp_min(1)
    return torch.where(valid, vote, 0.0).sum(dim=1) / n


def neighbor_mask_packed(join: JoinResult) -> torch.Tensor:
    """TSA2 input: per-point neighbor sets as packed int32 words
    ``[T, M, ceil(C/32)]`` (bit c set iff candidate c matches the point)."""
    return pack_bits(join.best_w > 0.0, rows_per_chunk=PACK_ROWS)
