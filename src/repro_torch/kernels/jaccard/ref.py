"""Bit-expanded oracle for the TSA2 Jaccard kernel (counterpart of
``repro.kernels.jaccard.ref``).

Deliberately the opposite formulation from the production paths: every
packed word is expanded to 32 booleans and each window union is a
w-unrolled shift chain.  O(M * w * W * 32) work — test shapes only; the
kernel's plain version at scale is ``core.segmentation.tsa2_signal``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.windows import unpack_bits


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
