"""Plain PyTorch versions of the LCSS kernel (counterpart of
``repro.kernels.lcss.ref`` and of the TPU kernel's own arithmetic in
``repro.kernels.lcss.lcss``).

Two formulations of one DP (DESIGN.md §2.2, Eqs. 1-2),

    L[i, j] = max(L[i-1, j], L[i, j-1], L[i-1, j-1] + w[i, j]),  L >= 0,

over the match weights of a (reference, candidate) pair, channel 0
weighted (``1 - d / eps_sp``), channel 1 unit (the classical count):

* ``lcss_ref``: the row scan of the JAX oracle, cell by cell;
* ``shear_weights`` + ``lcss_wavefront_ref``: the TPU kernel's sheared
  anti-diagonal wavefront, the plain twin of the CUDA kernel.

A cell is three exact maxima and one add in both, in the same order of
operands, so the two agree bit for bit with each other and with the CUDA
kernel.  Weights use ``sqrt_rn`` and float32 thresholds, and ``dx * dx +
dy * dy`` is two rounded products and a rounded sum (PyTorch does not
contract it to an FMA).
"""
from __future__ import annotations

import torch

from repro_torch.core.types import f32, sqrt_rn

NEG = -1e30


def match_weights(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t):
    """``[B, 2, N, M]``: the weighted (0) and unit (1) match weights of each
    cell, ``NEG`` where the points do not match."""
    dev = rx.device
    eps_sp, eps_t = f32(eps_sp, dev), f32(eps_t, dev)
    dx = rx[:, :, None] - sx[:, None, :]
    dy = ry[:, :, None] - sy[:, None, :]
    dt = (rt[:, :, None] - st[:, None, :]).abs()
    d = sqrt_rn(dx * dx + dy * dy)
    ok = (d <= eps_sp) & (dt <= eps_t) & rv[:, :, None] & sv[:, None, :]
    neg = f32(NEG, dev)
    w = torch.where(ok, 1.0 - d / eps_sp, neg)
    u = torch.where(ok, f32(1.0, dev), neg)
    return torch.stack([w, u], dim=1)


def lcss_ref(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t):
    """Batched row-scan DP, ``[B, N] x [B, M] -> [B, 2]`` (weighted, count),
    one row at a time.  Along a row, ``L[i, j] = max(L[i, j-1], L[i-1, j],
    L[i-1, j-1] + w[i, j], 0)`` unrolls to a running max (``cummax``) of
    ``max(L[i-1, j], L[i-1, j-1] + w[i, j], 0)``: the same add and the same
    exact maxima as the cell-by-cell scan, so the same bits."""
    wu = match_weights(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t)
    B, ch, N, M = wu.shape
    zero = torch.zeros((B, ch, 1), dtype=torch.float32, device=wu.device)
    prev = torch.zeros((B, ch, M), dtype=torch.float32, device=wu.device)
    for i in range(N):
        cand = torch.cat([zero, prev[..., :-1]], dim=-1) + wu[:, :, i]
        prev = torch.maximum(prev, cand).clamp_min(0.0).cummax(-1).values
    return prev[..., -1]


def lcss_similarity_ref(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t):
    """Eq. 1 / Eq. 2 similarities in [0, 1]: returns [B, 2]."""
    scores = lcss_ref(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t)
    return normalize(scores, rv, sv)


def normalize(scores, rv, sv):
    """Raw scores divided by ``min(|r|, |s|)`` valid points (at least 1)."""
    n, m = rv.sum(dim=1), sv.sum(dim=1)
    denom = torch.minimum(n, m).clamp_min(1).to(torch.float32)
    return scores / denom[:, None]


def shear_weights(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t):
    """The TPU kernel's host layout: match weights sheared to ``[B, 2, N,
    N+M-1]``, ``Ws[b, c, i, i + j] = w[b, c, i, j]``, ``NEG`` elsewhere, so
    that anti-diagonal ``d = i + j`` is column ``d``.  Written through a
    strided view of the output (no index tensors)."""
    wu = match_weights(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t)
    B, ch, N, M = wu.shape
    D = N + M - 1
    ws = torch.full((B, ch, N, D), NEG, dtype=torch.float32,
                    device=wu.device)
    ws.as_strided((B, ch, N, M), (ch * N * D, N * D, D + 1, 1)).copy_(wu)
    return ws


def lcss_wavefront_ref(ws):
    """The TPU kernel's sweep (``lcss.py::_kernel``), batched: ``ws`` ``[B,
    2, N, D]`` sheared weights -> ``[B, 2]`` = L at ``(N-1, M-1)``."""
    B, ch, N, D = ws.shape
    zero = torch.zeros((B, ch, 1), dtype=torch.float32, device=ws.device)

    def shift_down(v):                    # row i reads row i-1; row 0 reads 0
        return torch.cat([zero, v[..., :-1]], dim=-1)

    d1 = torch.zeros((B, ch, N), dtype=torch.float32, device=ws.device)
    d2 = d1
    for d in range(D):
        cand = shift_down(d2) + ws[..., d]
        d0 = torch.maximum(torch.maximum(d1, shift_down(d1)), cand)
        d1, d2 = d0.clamp_min(0.0), d1
    return d1[..., -1]
