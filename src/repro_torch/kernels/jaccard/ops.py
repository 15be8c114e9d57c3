"""Public wrapper for the TSA2 Jaccard kernel (counterpart of
``repro.kernels.jaccard.ops``).

Callers hand raw ``[T, M, W]`` packed int32 words and the ``[T, M]``
validity mask; the wrapper zeroes invalid positions (zero is the OR
identity, so padding never leaks into a window union).  CUDA tensors
launch ``jaccard_window`` (``csrc/dsc_kernels.cu``), which reads the words
as uint32; CPU tensors take the plain packed engine
(``core.segmentation.tsa2_signal``).  Both give the same ``d`` bit for
bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_cuda_operands, launch


def window_jaccard(masks: torch.Tensor, valid: torch.Tensor, *,
                   w: int) -> torch.Tensor:
    """TSA2's d[] signal from packed neighbor words ([T, M, W], [T, M])."""
    masks = torch.where(valid[..., None], masks, 0).contiguous()
    if not masks.is_cuda:
        from repro_torch.core.segmentation import tsa2_signal
        return tsa2_signal(masks, w)
    T, M, W = masks.shape
    dev = check_cuda_operands("jaccard_window", masks=(masks, torch.int32))
    d = torch.empty((T, M), dtype=torch.float32, device=dev)
    launch("jaccard_window", masks.data_ptr(), T, M, W, int(w),
           d.data_ptr(), device=dev)
    return d
