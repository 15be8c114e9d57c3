"""Plain PyTorch versions of the LCSS kernel (counterpart of
``repro.kernels.lcss.ref`` and of the TPU kernel's own arithmetic in
``repro.kernels.lcss.lcss``).

Two formulations of one DP (DESIGN.md §2.2, Eqs. 1-2),

    L[i, j] = max(L[i-1, j], L[i, j-1], L[i-1, j-1] + w[i, j]),  L >= 0,

over the match weights of a (reference, candidate) pair, channel 0
weighted (``1 - d / eps_sp``), channel 1 unit (the classical count):

* ``lcss_ref``: the row scan of the JAX oracle, cell by cell;
* ``shear_weights`` + ``lcss_wavefront_ref``: the TPU kernel's sheared
  anti-diagonal wavefront, the plain twin of the CUDA kernel;
* ``lcss_strip_ref``: the CUDA kernel's own schedule (one warp a pair,
  strips of rows, skewed steps, an exact time test before the weight),
  plainly, to show on the CPU that the schedule gives the same bits.

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
# K14's schedule (csrc/lcss_kernels.cu): pairs a block, one a warp
LCSS_WARPS = 4


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


def strip_rows(N: int) -> int:
    """R, the rows each lane owns in K14's strips of 32 R rows."""
    return 1 if N <= 32 else 2 if N <= 64 else 4


def strip_weights(px, py, pt, pv, qx, qy, qt, qv, eps_sp, eps_t):
    """K14's cell weights behind its time test, over broadcast operands:
    ``(w, u, timed)``; ``timed``: both points valid and not ``dt > eps_t``,
    the cells whose distance the kernel computes.  A NaN ``dt`` fails no
    rejecting test and fails the final one: equal to ``match_weights``."""
    dev = px.device
    eps_sp, eps_t = f32(eps_sp, dev), f32(eps_t, dev)
    dt = (pt - qt).abs()
    timed = pv & qv & ~(dt > eps_t)
    dx, dy = px - qx, py - qy
    d = sqrt_rn(dx * dx + dy * dy)
    ok = timed & (d <= eps_sp) & (dt <= eps_t)
    neg = f32(NEG, dev)
    w = torch.where(ok, 1.0 - d / eps_sp, neg)
    u = torch.where(ok, f32(1.0, dev), neg)
    return w, u, timed


def prefilter_counts(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t,
                     pairs: int = 4096) -> dict:
    """Cells of a batch by how far K14 takes them: ``cells``, ``valid``
    (both points valid), ``timed`` (past the time test: the weight is
    formed) and ``matched``; summed over slices of ``pairs`` pairs."""
    B, N = rx.shape
    M = sx.shape[1]
    n = dict(cells=B * N * M, valid=0, timed=0, matched=0)
    for b in range(0, B, pairs):
        r = [a[b:b + pairs, :, None] for a in (rx, ry, rt, rv)]
        c = [a[b:b + pairs, None, :] for a in (sx, sy, st, sv)]
        _, u, timed = strip_weights(*r, *c, eps_sp, eps_t)
        n["valid"] += int((r[3] & c[3]).sum())
        n["timed"] += int(timed.sum())
        n["matched"] += int((u > 0).sum())
    return n


def lcss_strip_ref(rx, ry, rt, rv, sx, sy, st, sv, eps_sp, eps_t):
    """K14's schedule, plainly (the kernel's mirror; ``lcss_ref`` is the
    contract), ``[B, 2]``.  For each strip of ``32 R`` rows (``R =
    strip_rows(N)``; lane ``k`` owns rows ``k R .. k R + R - 1``), step ``t``
    computes column ``j = t - k`` of every lane holding a row, its ``R``
    cells in order: the top row reads ``L[i-1, j]`` from the lane above
    (the bottom row it computed a step earlier, ``__shfl_up_sync``) or, at
    lane 0, from the carried bottom row of the strip above, which lane 31
    rewrites in place as it goes.  Weights come from ``strip_weights``; a
    cell that does not match takes ``max(L[i, j-1], L[i-1, j])`` alone (its
    candidate, below -1e29, and the clamp at 0 cannot change it: every L
    is +0 or positive), a matching one the plain version's add and
    maxima."""
    B, N = rx.shape
    M = sx.shape[1]
    dev = rx.device
    R = strip_rows(N)
    lane = torch.arange(32, device=dev)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=dev)
    carry = zeros(B, 2, M)
    out = zeros(B, 2)
    for s0 in range(0, N, 32 * R):
        lanes = -(-min(32 * R, N - s0) // R)
        above, below = s0 > 0, s0 + 32 * R < N
        i = s0 + lane[:, None] * R + torch.arange(R, device=dev)
        ic = i.clamp(max=N - 1)
        p = [a[:, ic] for a in (rx, ry, rt)] + [rv[:, ic] & (i < N)]
        L = zeros(B, 2, 32, R)
        bot, dg = zeros(B, 2, 32), zeros(B, 2, 32)
        for t in range(M + lanes - 1):
            top = (carry[:, :, t] if above and t < M else zeros(B, 2))
            up = torch.cat([top[..., None], bot[..., :-1]], dim=-1)
            j = t - lane
            act = (lane < lanes) & (j >= 0) & (j < M)
            jc = j.clamp(0, M - 1)
            q = [a[:, jc] for a in (sx, sy, st, sv)]
            a, d = up, dg
            new = L.clone()
            for r in range(R):
                w, u, _ = strip_weights(*(x[..., r] for x in p), *q,
                                        eps_sp, eps_t)
                m = torch.maximum(L[..., r], a)
                full = torch.maximum(m, d + torch.stack([w, u], dim=1))
                n = torch.where((u > 0)[:, None], full.clamp_min(0.0), m)
                d, a = L[..., r], n
                new[..., r] = n
            L = torch.where(act[:, None], new, L)
            bot = torch.where(act, L[..., R - 1], bot)
            if below and bool(act[31]):
                carry[:, :, t - 31] = bot[..., 31]
            dg = up
        if not below:
            last = N - 1 - s0
            out = L[:, :, last // R, last % R]
    return out

