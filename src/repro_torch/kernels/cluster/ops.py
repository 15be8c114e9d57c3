"""Public wrappers for the round-parallel clustering kernels (counterpart
of ``repro.kernels.cluster.ops``).

Callers pass natural ``[S]``, ``[S, S]`` or ``[S, K]`` operands.  CUDA
tensors launch ``round_scan`` / ``claim_max`` (dense matrix) and
``topk_round_scan`` / ``topk_claim_max`` (neighbor lists) from
``csrc/dsc_kernels.cu``, which take any ``S`` and ``K`` with no tiles and
no padding; CPU tensors take the plain versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import f32
from repro_torch.kernels import check_cuda_operands, launch
from repro_torch.kernels.cluster.ref import (claim_max_ref, round_scan_ref,
                                             topk_claim_max_ref,
                                             topk_round_scan_ref)


def _n_split(S: int) -> int:
    """Row slices of the [S, S] sweep: enough blocks to fill the card at
    full size (S = 32768: 256 column blocks x 16), one when S is small."""
    return 16 if S >= 4096 else 1


def cluster_round_scan(sim, rank, unresolved, is_rep, alpha):
    """(blocked [S], claimed [S]) — one fused round scan."""
    if not sim.is_cuda:
        return round_scan_ref(sim, rank, unresolved, is_rep, alpha)
    S = sim.shape[0]
    dev = check_cuda_operands(
        "round_scan", sim=(sim, torch.float32), rank=(rank, torch.int32),
        unresolved=(unresolved, torch.bool), is_rep=(is_rep, torch.bool))
    blocked = torch.zeros((S,), dtype=torch.bool, device=dev)
    claimed = torch.zeros((S,), dtype=torch.bool, device=dev)
    launch("round_scan", *(t.data_ptr() for t in (sim, rank, unresolved,
                                                  is_rep)),
           float(f32(alpha, "cpu")), S, _n_split(S), blocked.data_ptr(),
           claimed.data_ptr(), device=dev)
    return blocked, claimed


def cluster_assign(sim, rank, is_rep, valid, alpha):
    """(best_w [S], best_slot [S]) — final claim-max over rep rows."""
    if not sim.is_cuda:
        order = torch.empty_like(rank)
        order[rank.long()] = torch.arange(rank.shape[0], dtype=rank.dtype)
        return claim_max_ref(sim, order, rank, is_rep, valid, alpha)
    S = sim.shape[0]
    dev = check_cuda_operands(
        "claim_max", sim=(sim, torch.float32), rank=(rank, torch.int32),
        is_rep=(is_rep, torch.bool), valid=(valid, torch.bool))
    n = _n_split(S)
    part_w = torch.empty((n, S), dtype=torch.float32, device=dev)
    part_rank = torch.empty((n, S), dtype=torch.int32, device=dev)
    part_slot = torch.empty((n, S), dtype=torch.int32, device=dev)
    best_w = torch.empty((S,), dtype=torch.float32, device=dev)
    best_slot = torch.empty((S,), dtype=torch.int32, device=dev)
    launch("claim_max", *(t.data_ptr() for t in (sim, rank, is_rep, valid)),
           float(f32(alpha, "cpu")), S,
           *(t.data_ptr() for t in (part_w, part_rank, part_slot)), n,
           best_w.data_ptr(), best_slot.data_ptr(), device=dev)
    return best_w, best_slot


def _check_lists(name, ids, sims, rank, **vecs):
    S = rank.shape[0]
    if ids.shape != sims.shape or ids.dim() != 2 or ids.shape[0] != S:
        raise ValueError(f"{name}: ids {tuple(ids.shape)} and sims "
                         f"{tuple(sims.shape)} must both be [S={S}, K]")
    return check_cuda_operands(
        name, ids=(ids, torch.int32), sims=(sims, torch.float32),
        rank=(rank, torch.int32),
        **{k: (v, torch.bool) for k, v in vecs.items()})


def topk_cluster_round_scan(ids, sims, rank, unresolved, is_rep, alpha):
    """(blocked [S], claimed [S]) — one round scan over ``[S, K]`` lists."""
    if not ids.is_cuda:
        return topk_round_scan_ref(ids, sims, rank, unresolved, is_rep,
                                   alpha)
    S, K = ids.shape
    dev = _check_lists("topk_round_scan", ids, sims, rank,
                       unresolved=unresolved, is_rep=is_rep)
    blocked = torch.empty((S,), dtype=torch.bool, device=dev)
    claimed = torch.empty((S,), dtype=torch.bool, device=dev)
    launch("topk_round_scan", *(t.data_ptr() for t in (ids, sims, rank,
                                                       unresolved, is_rep)),
           float(f32(alpha, "cpu")), S, K, blocked.data_ptr(),
           claimed.data_ptr(), device=dev)
    return blocked, claimed


def topk_cluster_assign(ids, sims, rank, is_rep, valid, alpha):
    """(best_w [S], best_slot [S]) — claim-max over ``[S, K]`` lists."""
    if not ids.is_cuda:
        return topk_claim_max_ref(ids, sims, rank, is_rep, valid, alpha)
    S, K = ids.shape
    dev = _check_lists("topk_claim_max", ids, sims, rank, is_rep=is_rep,
                       valid=valid)
    best_w = torch.empty((S,), dtype=torch.float32, device=dev)
    best_slot = torch.empty((S,), dtype=torch.int32, device=dev)
    launch("topk_claim_max", *(t.data_ptr() for t in (ids, sims, rank,
                                                      is_rep, valid)),
           float(f32(alpha, "cpu")), S, K, best_w.data_ptr(),
           best_slot.data_ptr(), device=dev)
    return best_w, best_slot
