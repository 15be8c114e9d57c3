"""Public wrapper: TrajectoryBatch-level subtrajectory join through the
join kernel (counterpart of ``repro.kernels.stjoin.ops``; this slice
ports the dense ``best_match_join_kernel`` and ``subtrajectory_join``).

Dispatch is on the tensors' device: CUDA tensors launch the CUDA kernel
(``csrc/dsc_kernels.cu``, ``stjoin_best_match``), CPU tensors take the
plain version in ``ref.py``.  The kernel needs no padding: it writes the
``[T*M, C]`` result straight into the ``[T, M, C]`` cube.  Numerics are
set out in this package's docstring.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import filter_delta_t
from repro_torch.core.types import JoinResult, TrajectoryBatch, f32
from repro_torch.kernels import check_cuda_operands, launch
from repro_torch.kernels.stjoin.ref import stjoin_ref


def stjoin_best_match(ref_x, ref_y, ref_t, ref_id, ref_ok,
                      cand_x, cand_y, cand_t, cand_id, cand_ok, eps_sp,
                      eps_t, *, out_w=None, out_idx=None):
    """``(best_w [P, C] f32, best_idx [P, C] i32)`` — the K1 contract.

    ``out_w`` / ``out_idx`` may name ``[P, C]`` views to write into.
    """
    if not ref_x.is_cuda:
        w, idx = stjoin_ref(ref_x, ref_y, ref_t, ref_id, ref_ok, cand_x,
                            cand_y, cand_t, cand_id, cand_ok, eps_sp, eps_t)
        if out_w is not None:
            out_w.copy_(w)
            out_idx.copy_(idx)
            return out_w, out_idx
        return w, idx
    P = ref_x.shape[0]
    C, Mc = cand_x.shape
    f, i, b = torch.float32, torch.int32, torch.bool
    dev = check_cuda_operands(
        "stjoin_best_match", ref_x=(ref_x, f), ref_y=(ref_y, f),
        ref_t=(ref_t, f), ref_id=(ref_id, i), ref_ok=(ref_ok, b),
        cand_x=(cand_x, f), cand_y=(cand_y, f), cand_t=(cand_t, f),
        cand_id=(cand_id, i), cand_ok=(cand_ok, b))
    if (C + 31) // 32 > 65535:
        raise ValueError(f"stjoin_best_match: C={C} exceeds the grid")
    if out_w is None:
        out_w = torch.empty((P, C), dtype=f, device=dev)
        out_idx = torch.empty((P, C), dtype=i, device=dev)
    check_cuda_operands("stjoin_best_match", ref_x=(ref_x, f),
                        out_w=(out_w, f), out_idx=(out_idx, i))
    if out_w.shape != (P, C) or out_idx.shape != (P, C):
        raise ValueError("stjoin_best_match: outputs must be [P, C]")
    ops = (ref_x, ref_y, ref_t, ref_id, ref_ok, cand_x, cand_y, cand_t,
           cand_id, cand_ok)
    launch("stjoin_best_match", *(t.data_ptr() for t in ops), P, C, Mc,
           float(f32(eps_sp, "cpu")), float(f32(eps_t, "cpu")),
           out_w.data_ptr(), out_idx.data_ptr(), device=dev)
    return out_w, out_idx


def best_match_join_kernel(ref: TrajectoryBatch, cand: TrajectoryBatch,
                           eps_sp, eps_t) -> JoinResult:
    """Dense best-match join through K1: ``JoinResult [T, M, C]``."""
    T, M = ref.x.shape
    C = cand.x.shape[0]
    best_w = torch.empty((T, M, C), dtype=torch.float32, device=ref.device)
    best_idx = torch.empty((T, M, C), dtype=torch.int32, device=ref.device)
    rid = ref.traj_id[:, None].expand(T, M).contiguous()
    stjoin_best_match(
        ref.x.reshape(-1), ref.y.reshape(-1), ref.t.reshape(-1),
        rid.reshape(-1), ref.valid.reshape(-1),
        cand.x.contiguous(), cand.y.contiguous(), cand.t.contiguous(),
        cand.traj_id.contiguous(), cand.valid.contiguous(), eps_sp, eps_t,
        out_w=best_w.view(T * M, C), out_idx=best_idx.view(T * M, C))
    return JoinResult(best_w=best_w, best_idx=best_idx)


def subtrajectory_join(ref: TrajectoryBatch, cand: TrajectoryBatch,
                       eps_sp, eps_t, delta_t=0.0, *,
                       use_index: bool = False) -> JoinResult:
    """Kernel-backed Problem 1 (join + delta_t refine)."""
    if use_index:
        raise NotImplementedError(
            "use_index: the pruned join kernel (K10) is ROADMAP queue 1 "
            "item 8")
    j = best_match_join_kernel(ref, cand, eps_sp, eps_t)
    if float(delta_t) > 0.0:
        return filter_delta_t(j, ref.t, delta_t)
    return j
