"""Public wrappers: exact pairwise (weighted) LCSS (counterpart of
``repro.kernels.lcss.ops``).

``lcss_scores`` / ``lcss_similarity`` move their operands to ``device``
(``None`` = the card) and call ``lcss_wavefront``: on CUDA tensors it
launches the ``lcss_wavefront`` kernel (``csrc/lcss_kernels.cu``: one warp
a pair, the DP in registers, the weights formed there behind an exact
time test; the sheared tensor is never built); on CPU tensors it takes
the plain versions of the TPU kernel's two steps (``ref.shear_weights``
then ``ref.lcss_wavefront_ref``).  Both give the same scores bit for bit.
Pairs of more than one strip of rows (N > 128) carry a strip's bottom row
to the next, in shared memory while ``smem_bytes`` fits the card's opt-in
limit, else in a global scratch that the wrapper allocates.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (check_cuda_operands, launch, resolve_device,
                                 smem_optin)
from repro_torch.kernels.lcss.ref import (LCSS_WARPS, lcss_wavefront_ref,
                                          normalize, shear_weights,
                                          strip_rows)


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
    if smem_bytes(N, M) > smem_optin(dev.index):
        scratch = torch.empty(B * 2 * M, dtype=f, device=dev)
    launch("lcss_wavefront", rx.data_ptr(), ry.data_ptr(), rt.data_ptr(),
           rv.data_ptr(), sx.data_ptr(), sy.data_ptr(), st.data_ptr(),
           sv.data_ptr(), B, N, M, float(eps_sp), float(eps_t),
           0 if scratch is None else scratch.data_ptr(), scores.data_ptr(),
           device=dev)
    return scores


def smem_bytes(N: int, M: int) -> int:
    """Shared memory of one K14 block (``lcss_kernels.cu``): the ring of 64
    candidate points of each of its ``LCSS_WARPS`` warps and, when the rows
    take more than one strip, each warp's carried row (2 x M floats).  Past
    the card's opt-in limit the carried rows go to a global scratch of
    ``2 M`` floats a pair."""
    ring = LCSS_WARPS * 64 * 16
    if N <= 32 * strip_rows(N):
        return ring
    return ring + LCSS_WARPS * 2 * M * 4


def _operands(dev, rx, ry, rt, rv, sx, sy, st, sv):
    f = [torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
         for a in (rx, ry, rt, sx, sy, st)]
    b = [torch.as_tensor(a, dtype=torch.bool, device=dev).contiguous()
         for a in (rv, sv)]
    return f[0], f[1], f[2], b[0], f[3], f[4], f[5], b[1]


def lcss_scores(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t, *,
                interpret: bool | None = None, device=None) -> torch.Tensor:
    """[B, 2] raw DP scores (weighted Eq. 2 numerator, classical count),
    clamped at zero (an all-invalid pair yields an empty DP, not a
    negative score).  ``device``: where to run (``None`` = the card).  The
    reference's ``interpret`` (Pallas' interpret mode) is accepted and
    ignored."""
    dev = resolve_device(device)
    ops = _operands(dev, rx, ry, rt, rv, sx, sy, st, sv)
    return lcss_wavefront(*ops, eps_sp, eps_t).clamp_min(0.0)


def lcss_similarity(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t, *,
                    interpret: bool | None = None,
                    device=None) -> torch.Tensor:
    """Eq. 1 (channel 1) and Eq. 2 (channel 0) similarities, [B, 2]: the
    raw DP scores normalized by ``min(|r|, |s|)`` valid points
    (``interpret`` as in ``lcss_scores``)."""
    dev = resolve_device(device)
    ops = _operands(dev, rx, ry, rt, rv, sx, sy, st, sv)
    return normalize(lcss_scores(*ops, eps_sp, eps_t, device=dev), ops[3],
                     ops[7])
