"""Public wrapper for the TSA2 Jaccard kernel (counterpart of
``repro.kernels.jaccard.ops``).

Callers hand raw ``[T, M, W]`` packed int32 words and the ``[T, M]``
validity mask; invalid positions count as zero words (zero is the OR
identity, so padding never leaks into a window union).  CUDA tensors
launch ``jaccard_window`` (``csrc/dsc_kernels.cu``), which reads the words
as uint32 and never reads an invalid position's words; CPU tensors zero
them and take the plain packed engine (``core.segmentation.tsa2_signal``).
Both give the same ``d`` bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import check_cuda_operands, launch, smem_optin

# shared memory a block of the kernel sizes its column slab to, so that
# several blocks share an SM (the opt-in limit only where one column does
# not fit), and the blocks of the global-scratch path past the limit
SLAB_SMEM = 48 * 1024
SCRATCH_BLOCKS = 256


def slab_words(M: int, J: int) -> int:
    """32-bit words of one block's tiles at a slab of ``J`` columns:
    ``dsc_kernels.cu::jaccard_words``."""
    return M * (2 * (J + 1) + 2) + (M + 3) // 4


def slab_plan(M: int, W: int, limit: int) -> tuple[int, bool]:
    """``(J, scratch)``: the kernel's column slab, the widest power of two
    up to 32 (no wider than ``W`` needs) whose tiles fit ``SLAB_SMEM``,
    else one column; ``scratch`` when even that passes ``limit`` bytes."""
    J = 32
    while J > 1 and J >= 2 * W:
        J //= 2
    while J > 1 and slab_words(M, J) * 4 > SLAB_SMEM:
        J //= 2
    return J, slab_words(M, J) * 4 > limit


def window_jaccard(masks: torch.Tensor, valid: torch.Tensor, *, w: int,
                   interpret: bool | None = None) -> torch.Tensor:
    """TSA2's d[] signal from packed neighbor words ([T, M, W], [T, M]).
    The reference's ``interpret`` (Pallas' interpret mode) is accepted and
    ignored."""
    if not masks.is_cuda:
        from repro_torch.core.segmentation import tsa2_signal
        return tsa2_signal(torch.where(valid[..., None], masks, 0), w)
    T, M, W = masks.shape
    if valid.shape != (T, M):
        raise ValueError(f"jaccard_window: valid {tuple(valid.shape)} is "
                         f"not [T={T}, M={M}]")
    masks, valid = masks.contiguous(), valid.contiguous()
    dev = check_cuda_operands("jaccard_window", masks=(masks, torch.int32),
                              valid=(valid, torch.bool))
    J, spill = slab_plan(M, W, smem_optin(dev.index))
    blocks, scratch = 0, None
    if spill:
        blocks = min(T, SCRATCH_BLOCKS)
        scratch = torch.empty(blocks * slab_words(M, J), dtype=torch.int32,
                              device=dev)
    d = torch.empty((T, M), dtype=torch.float32, device=dev)
    launch("jaccard_window", masks.data_ptr(), valid.data_ptr(), T, M, W,
           int(w), J, 0 if scratch is None else scratch.data_ptr(), blocks,
           d.data_ptr(), device=dev)
    return d
