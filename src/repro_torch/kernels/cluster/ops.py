"""Public wrappers for the round-parallel clustering kernels (counterpart
of ``repro.kernels.cluster.ops``).

Callers pass natural ``[S]``, ``[S, S]`` or ``[S, K]`` operands.  CUDA
tensors launch ``round_scan`` / ``claim_max`` (dense matrix),
``topk_round_scan`` / ``topk_claim_max`` (neighbor lists) and
``sim_row_moments`` (the row moments of alpha, on a matrix or a block of
its rows or columns) from ``csrc/dsc_kernels.cu``, which take any ``S``
and ``K`` with no tiles and no padding; CPU tensors take the plain
versions in ``ref.py``.  ``alpha``
may be a Python float, a CPU tensor or a tensor on the operands' card:
the kernels read a card tensor there (no host sync, so a call can be
captured in a CUDA graph), anything else as a float32 value.

The wrappers take the reference's TPU knobs with its defaults: ``bu`` /
``bs`` (the Pallas tile geometry, ``plan_tiles``) and ``interpret``.  The
reference's outputs are bitwise the same for every geometry (padded slots
join no reduction) and in either mode, so the knobs are accepted and
ignored; a tile size no Pallas grid could run is refused.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.types import f32
from repro_torch.kernels import (check_cuda_operands, check_tile_knobs,
                                 launch, library)
from repro_torch.kernels.cluster.ref import (cluster_assign_ref,
                                             round_scan_ref,
                                             sim_row_moments_ref,
                                             topk_claim_max_ref,
                                             topk_round_scan_ref)


def plan_tiles(S: int, target_bu: int = 8, target_bs: int = 128):
    """(bu, bs, S_padded): the reference's Pallas row / column tile sizes
    and its padded slot count (a copy of ``repro.kernels.cluster.ops.
    plan_tiles``: the targets taken verbatim, ``S`` padded up to a common
    multiple of both).  Host arithmetic only: the port's kernels take any
    ``S`` unpadded and read none of it."""
    bu, bs = target_bu, target_bs
    q = math.lcm(bu, bs)
    return bu, bs, -(-S // q) * q


@functools.lru_cache(maxsize=None)
def _claim_scratch(device: int, S: int) -> int:
    """int32 words of K6's scratch on card ``device`` (its launcher's
    rule: the row list, the slice counters and the slices' partials)."""
    with torch.cuda.device(device):
        n = library().claim_max_scratch(S)
    if n < 0:
        raise RuntimeError(f"claim_max: scratch query failed: error {-n}")
    return n


def _alpha_args(alpha, dev: torch.device) -> tuple:
    """``(pointer or None, value)`` of a launcher's alpha: a tensor on
    ``dev`` is read there (the launch is ordered on the stream before any
    reuse of a temporary's memory), anything else on the host."""
    if torch.is_tensor(alpha) and alpha.device == dev:
        return alpha.to(torch.float32).data_ptr(), 0.0
    return None, float(f32(alpha, "cpu"))


def cluster_round_scan(sim, rank, unresolved, is_rep, alpha, *,
                       bu: int = 8, bs: int = 128, interpret: bool = True):
    """(blocked [S], claimed [S]) — one fused round scan."""
    check_tile_knobs("round_scan", bu=bu, bs=bs)
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
           *_alpha_args(alpha, dev), S, blocked.data_ptr(),
           claimed.data_ptr(), device=dev)
    return blocked, claimed


def cluster_assign(sim, rank, is_rep, valid, alpha, *, bu: int = 8,
                   bs: int = 128, interpret: bool = True):
    """(best_w [S], best_slot [S]) — final claim-max over rep rows: per
    valid column the maximum weight, then the minimum rank, then the
    lowest row, for any int32 ``rank``."""
    check_tile_knobs("claim_max", bu=bu, bs=bs)
    if not sim.is_cuda:
        return cluster_assign_ref(sim, rank, is_rep, valid, alpha)
    S = sim.shape[0]
    dev = check_cuda_operands(
        "claim_max", sim=(sim, torch.float32), rank=(rank, torch.int32),
        is_rep=(is_rep, torch.bool), valid=(valid, torch.bool))
    n = _claim_scratch(dev.index, S)
    scratch = torch.empty((n,), dtype=torch.int32, device=dev)
    best_w = torch.empty((S,), dtype=torch.float32, device=dev)
    best_slot = torch.empty((S,), dtype=torch.int32, device=dev)
    launch("claim_max", *(t.data_ptr() for t in (sim, rank, is_rep, valid)),
           *_alpha_args(alpha, dev), S, scratch.data_ptr(), n,
           best_w.data_ptr(), best_slot.data_ptr(), device=dev)
    return best_w, best_slot


def sim_row_moments(sim_rows, row_valid, col_valid):
    """(count [R], sum [R], sum of squares [R]) — the row moments of alpha
    (``sim_row_moments_ref``), bitwise its tree: K16, one launch over all
    rows, which replaces no Pallas kernel (the reference's moments are
    plain jnp).  ``sim_rows`` may be a strided view whose columns are
    adjacent (a column block of a wider matrix)."""
    if not sim_rows.is_cuda:
        return sim_row_moments_ref(sim_rows, row_valid, col_valid)
    R, N = sim_rows.shape
    dev = check_cuda_operands("sim_row_moments",
                              row_valid=(row_valid, torch.bool),
                              col_valid=(col_valid, torch.bool))
    if (sim_rows.device != dev or sim_rows.dtype != torch.float32
            or (N > 1 and sim_rows.stride(1) != 1)
            or row_valid.shape != (R,) or col_valid.shape != (N,)):
        raise ValueError(
            f"sim_row_moments: sim_rows {sim_rows.dtype} "
            f"{tuple(sim_rows.shape)} strides {sim_rows.stride()} on "
            f"{sim_rows.device} must be float32 [R, N] with adjacent "
            f"columns on {dev}, row_valid [R], col_valid [N]; got "
            f"{tuple(row_valid.shape)}, {tuple(col_valid.shape)}")
    cnt = torch.empty((R,), dtype=torch.int32, device=dev)
    rsum = torch.empty((R,), dtype=torch.float32, device=dev)
    rsumsq = torch.empty((R,), dtype=torch.float32, device=dev)
    launch("sim_row_moments", sim_rows.data_ptr(), sim_rows.stride(0),
           row_valid.data_ptr(), col_valid.data_ptr(), R, N, cnt.data_ptr(),
           rsum.data_ptr(), rsumsq.data_ptr(), device=dev)
    return cnt, rsum, rsumsq


def _check_lists(name, ids, sims, rank, **vecs):
    S = rank.shape[0]
    if ids.shape != sims.shape or ids.dim() != 2 or ids.shape[0] != S:
        raise ValueError(f"{name}: ids {tuple(ids.shape)} and sims "
                         f"{tuple(sims.shape)} must both be [S={S}, K]")
    return check_cuda_operands(
        name, ids=(ids, torch.int32), sims=(sims, torch.float32),
        rank=(rank, torch.int32),
        **{k: (v, torch.bool) for k, v in vecs.items()})


def topk_cluster_round_scan(ids, sims, rank, unresolved, is_rep, alpha, *,
                            bs: int = 8, interpret: bool = True):
    """(blocked [S], claimed [S]) — one round scan over ``[S, K]`` lists."""
    check_tile_knobs("topk_round_scan", bs=bs)
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
           *_alpha_args(alpha, dev), S, K, blocked.data_ptr(),
           claimed.data_ptr(), device=dev)
    return blocked, claimed


def topk_cluster_assign(ids, sims, rank, is_rep, valid, alpha, *,
                        bs: int = 8, interpret: bool = True):
    """(best_w [S], best_slot [S]) — claim-max over ``[S, K]`` lists."""
    check_tile_knobs("topk_claim_max", bs=bs)
    if not ids.is_cuda:
        return topk_claim_max_ref(ids, sims, rank, is_rep, valid, alpha)
    S, K = ids.shape
    dev = _check_lists("topk_claim_max", ids, sims, rank, is_rep=is_rep,
                       valid=valid)
    best_w = torch.empty((S,), dtype=torch.float32, device=dev)
    best_slot = torch.empty((S,), dtype=torch.int32, device=dev)
    launch("topk_claim_max", *(t.data_ptr() for t in (ids, sims, rank,
                                                      is_rep, valid)),
           *_alpha_args(alpha, dev), S, K, best_w.data_ptr(),
           best_slot.data_ptr(), device=dev)
    return best_w, best_slot
