"""Bit-expanded oracle for the TSA2 Jaccard kernel (counterpart of
``repro.kernels.jaccard.ref``), and the plain mirror of the kernel's
schedule.

``jaccard_ref`` is deliberately the opposite formulation from the
production paths: every packed word is expanded to 32 booleans and each
window union is a w-unrolled shift chain.  O(M * w * W * 32) work — test
shapes only; the kernel's plain version at scale is
``core.segmentation.tsa2_signal``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.windows import popcount32, unpack_bits


def jaccard_ref(masks: torch.Tensor, w: int) -> torch.Tensor:
    """[T, M, W] int32 packed -> [T, M] Jaccard dissimilarity d[n]."""
    T, M, W = masks.shape
    bits = unpack_bits(masks)                                 # [T, M, 32W]

    def union_over(lo, hi):          # inclusive index offsets per position
        out = torch.zeros_like(bits)
        for k in range(lo, hi + 1):
            if k <= 0:               # position n reads n - k (ahead)
                src = F.pad(bits[:, -k:], (0, 0, 0, min(-k, M)))[:, :M]
            else:                    # position n reads n - k (behind)
                src = F.pad(bits[:, :max(M - k, 0)], (0, 0, min(k, M), 0))
            out = out | src
        return out

    l1 = union_over(1, w)            # positions n-w .. n-1
    l2 = union_over(-(w - 1), 0)     # positions n .. n+w-1
    inter = (l1 & l2).sum(dim=-1).to(torch.float32)
    union = (l1 | l2).sum(dim=-1).to(torch.float32)
    return torch.where(union > 0, 1.0 - inter / union.clamp_min(1.0), 0.0)


def jaccard_schedule_ref(masks: torch.Tensor, valid: torch.Tensor, w: int,
                         slab: int) -> torch.Tensor:
    """The kernel's schedule, plainly (``csrc/dsc_kernels.cu``,
    ``jaccard_window_kernel``; ``tsa2_signal`` is the contract): column
    slabs of ``slab`` words, invalid positions staged as zeros; with
    ``we = min(w, M)`` the suffix ORs ``S`` and prefix ORs ``P`` of each
    segment ``[s we, (s+1) we)``; ``l1[m] = P[m-1] | S[m-we]`` and ``l2[m]
    = S[m] | P[m+we-1]`` (past ``M - 1``: ``P[M-1]`` if that position's
    segment starts before ``M``, else 0); integer counts summed over the
    slabs.  ``[T, M]`` float32, bitwise ``tsa2_signal`` of the masked
    words."""
    T, M, W = masks.shape
    dev = masks.device
    inter = torch.zeros((T, M), dtype=torch.int32, device=dev)
    union = torch.zeros_like(inter)
    we = min(w, M)
    if we > 0:
        m = torch.arange(M, device=dev)
        q = m + we - 1
        pq = torch.where(q < M, q, torch.where((q // we) * we <= M - 1,
                                               M - 1, -1))
        for j0 in range(0, W, slab):
            x = torch.where(valid[..., None], masks[:, :, j0:j0 + slab], 0)
            pre, suf = torch.empty_like(x), torch.empty_like(x)
            for a in range(0, M, we):
                acc = torch.zeros_like(x[:, 0])
                for k in range(min(M, a + we) - 1, a - 1, -1):
                    acc = acc | x[:, k]
                    suf[:, k] = acc
                acc = torch.zeros_like(x[:, 0])
                for k in range(a, min(M, a + we)):
                    acc = acc | x[:, k]
                    pre[:, k] = acc
            zero = torch.zeros_like(x)
            l1 = (torch.where((m >= 1)[None, :, None],
                              pre[:, (m - 1).clamp_min(0)], zero)
                  | torch.where((m >= we)[None, :, None],
                                suf[:, (m - we).clamp_min(0)], zero))
            l2 = suf | torch.where((pq >= 0)[None, :, None],
                                   pre[:, pq.clamp_min(0)], zero)
            inter += popcount32(l1 & l2).sum(dim=-1, dtype=torch.int32)
            union += popcount32(l1 | l2).sum(dim=-1, dtype=torch.int32)
    inter = inter.to(torch.float32)
    union = union.to(torch.float32)
    return torch.where(union > 0, 1.0 - inter / union.clamp_min(1.0), 0.0)
