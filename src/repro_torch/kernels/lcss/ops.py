"""Public wrappers: exact pairwise (weighted) LCSS (counterpart of
``repro.kernels.lcss.ops``).

``lcss_scores`` / ``lcss_similarity`` move their operands to ``device``
(``None`` = the card) and call ``lcss_wavefront``: on CUDA tensors it
launches the ``lcss_wavefront`` kernel (``csrc/lcss_kernels.cu``), which
forms the match weights in registers and never builds the sheared tensor;
on CPU tensors it takes the plain versions of the TPU kernel's two steps
(``ref.shear_weights`` then ``ref.lcss_wavefront_ref``).  Both give the
same scores bit for bit.  Pairs too long for the kernel's shared memory
(``smem_bytes`` above the card's opt-in limit) keep its diagonals in a
global scratch that the wrapper allocates.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import check_cuda_operands, launch, resolve_device
from repro_torch.kernels.lcss.ref import (lcss_wavefront_ref, normalize,
                                          shear_weights)


def lcss_wavefront(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t):
    """``[B, 2]`` raw DP scores of each (``r``, ``s``) pair: float32 ``[B, N]``
    / ``[B, M]`` coordinates and bool validity, all on one device."""
    B, N = rx.shape
    M = sx.shape[1]
    if N == 0 or M == 0:
        raise ValueError(f"lcss: empty sequences (N={N}, M={M})")
    if not rx.is_cuda:
        return lcss_wavefront_ref(shear_weights(rx, ry, rt, rv, sx, sy, st,
                                                sv, eps_sp, eps_t))
    f, b = torch.float32, torch.bool
    dev = check_cuda_operands("lcss_wavefront", rx=(rx, f), ry=(ry, f),
                              rt=(rt, f), rv=(rv, b), sx=(sx, f), sy=(sy, f),
                              st=(st, f), sv=(sv, b))
    for name, t, n in (("r", (rx, ry, rt, rv), N), ("s", (sx, sy, st, sv), M)):
        if any(a.shape != (B, n) for a in t):
            raise ValueError(f"lcss_wavefront: {name} operands are not all "
                             f"[{B}, {n}]")
    scores = torch.empty((B, 2), dtype=f, device=dev)
    scratch = None
    if smem_bytes(N, M) > _smem_optin(dev.index or 0):
        scratch = torch.empty(B * 6 * N, dtype=f, device=dev)
    launch("lcss_wavefront", rx.data_ptr(), ry.data_ptr(), rt.data_ptr(),
           rv.data_ptr(), sx.data_ptr(), sy.data_ptr(), st.data_ptr(),
           sv.data_ptr(), B, N, M, float(eps_sp), float(eps_t),
           0 if scratch is None else scratch.data_ptr(), scores.data_ptr(),
           device=dev)
    return scores


def smem_bytes(N: int, M: int) -> int:
    """Shared memory of one K14 block (``lcss_kernels.cu::lcss_smem_bytes``):
    three diagonals of both channels and both sequences' points, in
    floats.  Past the card's opt-in limit the diagonals go to a global
    scratch of ``6 N`` floats a pair."""
    return 4 * (10 * N + 4 * M)


@functools.lru_cache(maxsize=None)
def _smem_optin(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return getattr(props, "shared_memory_per_block_optin", 232448)


def _operands(dev, rx, ry, rt, rv, sx, sy, st, sv):
    f = [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
         for a in (rx, ry, rt, sx, sy, st)]
    b = [torch.as_tensor(a, dtype=torch.bool, device=dev).contiguous()
         for a in (rv, sv)]
    return f[0], f[1], f[2], b[0], f[3], f[4], f[5], b[1]


def lcss_scores(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t, *,
                device=None) -> torch.Tensor:
    """[B, 2] raw DP scores (weighted Eq. 2 numerator, classical count),
    clamped at zero (an all-invalid pair yields an empty DP, not a
    negative score).  ``device``: where to run (``None`` = the card)."""
    dev = resolve_device(device)
    ops = _operands(dev, rx, ry, rt, rv, sx, sy, st, sv)
    return lcss_wavefront(*ops, eps_sp, eps_t).clamp_min(0.0)


def lcss_similarity(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t, *,
                    device=None) -> torch.Tensor:
    """Eq. 1 (channel 1) and Eq. 2 (channel 0) similarities, [B, 2]: the
    raw DP scores normalized by ``min(|r|, |s|)`` valid points."""
    dev = resolve_device(device)
    ops = _operands(dev, rx, ry, rt, rv, sx, sy, st, sv)
    return normalize(lcss_scores(*ops, eps_sp, eps_t, device=dev), ops[3],
                     ops[7])
