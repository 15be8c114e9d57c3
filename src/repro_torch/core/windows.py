"""Sliding-window reductions and the bit-packing helpers
(counterpart of ``repro.core.windows``).

Every windowed quantity TSA1/TSA2 need is a reduction of a per-position
signal over the inclusive offset window ``[n + lo, n + hi]`` along axis 1,
out-of-range positions contributing the identity:

    window means   (TSA1)  -> "sum"  over [n-w, n-1] and [n, n+w-1]
    local-max test (both)  -> "max"  over [n-w+1, n-1] and [n+1, n+w-1]
    set unions     (TSA2)  -> "or"   over [n-w, n-1] and [n, n+w-1],
                              directly on packed int32 words

"sum" reads one prefix sum twice.  "max" and "or" are idempotent, so the
trailing window of length L is built by doubling: a window of length c
combined with itself shifted by ``min(c, L - c)`` covers ``c + step``
positions (overlap is absorbed), in ``ceil(log2 L)`` steps.

Packed words are ``int32`` bit patterns (bit c of word c // 32): PyTorch's
``uint32`` has no shifts on the CPU, so logical shifts are written as
``(x >> k) & mask`` and popcount is a SWAR helper.
"""
from __future__ import annotations

import numpy as np
import torch

_OPS = ("sum", "max", "or")

# 1 << k for k < 32 as int32 bit patterns (bit 31 is INT32_MIN)
_BIT_WEIGHTS = np.array([1 << k for k in range(32)], np.uint32).view(np.int32)


def _identity(dtype: torch.dtype, op: str):
    if op in ("sum", "or"):
        return 0
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _shift(x: torch.Tensor, k: int, ident, dim: int = 1) -> torch.Tensor:
    """``x`` shifted so position n reads ``x[n - k]`` (identity off-edge)."""
    if k == 0:
        return x
    n = x.shape[dim]
    kk = min(abs(k), n)
    pad_shape = list(x.shape)
    pad_shape[dim] = kk
    pad = torch.full(pad_shape, ident, dtype=x.dtype, device=x.device)
    if k > 0:
        return torch.cat([pad, x.narrow(dim, 0, n - kk)], dim=dim)
    return torch.cat([x.narrow(dim, kk, n - kk), pad], dim=dim)


def _prefix_at(csum: torch.Tensor, k: int) -> torch.Tensor:
    """``csum[:, n + k]`` with 0 below index 0 and the last column above
    ``M - 1`` (a prefix sum saturates past the end)."""
    M = csum.shape[1]
    if k == 0:
        return csum
    if k < 0:
        return _shift(csum, -k, 0)
    kk = min(k, M)
    edge = csum[:, M - 1:M].expand_as(csum[:, :kk])
    return torch.cat([csum[:, kk:], edge], dim=1)


def _combine(op: str):
    return torch.maximum if op == "max" else torch.bitwise_or


def sliding_reduce(sig: torch.Tensor, lo: int, hi: int, op: str) -> torch.Tensor:
    """Reduce ``sig`` over the inclusive offset window ``[n+lo, n+hi]``.

    ``lo``/``hi`` are Python ints (either sign); positions outside
    ``[0, M)`` contribute the identity (0 for sum/or, -inf or the dtype's
    minimum for max).  An empty window returns the identity everywhere.
    Output shape == input shape; windows slide along axis 1.
    """
    if op not in _OPS:
        raise ValueError(f"unknown window op {op!r}")
    M = sig.shape[1]
    ident = _identity(sig.dtype, op)
    if lo > hi:
        return torch.full_like(sig, ident)
    if op == "sum":
        csum = torch.cumsum(sig, dim=1)
        return _prefix_at(csum, hi) - _prefix_at(csum, lo - 1)

    L = hi - lo + 1
    pad_r = max(hi, 0)
    y = sig
    if pad_r:
        pad_shape = list(sig.shape)
        pad_shape[1] = pad_r
        y = torch.cat([sig, torch.full(pad_shape, ident, dtype=sig.dtype,
                                       device=sig.device)], dim=1)
    combine = _combine(op)
    incl, c = y, 1
    while c < L:           # incl[m] = reduce(y[m-c+1 .. m])
        step = min(c, L - c)
        incl = combine(incl, _shift(incl, step, ident))
        c += step
    if hi >= 0:
        return incl[:, hi:hi + M]
    return _shift(incl[:, :M], -hi, ident)


def window_pair(sig: torch.Tensor, w: int, op: str):
    """``W1 = [n-w, n-1]`` and ``W2 = [n, n+w-1]``: returns ``(r1, r2)``."""
    return (sliding_reduce(sig, -w, -1, op),
            sliding_reduce(sig, 0, w - 1, op))


def pack_bits(b: torch.Tensor, rows_per_chunk: int | None = None) -> torch.Tensor:
    """[..., C] bool -> [..., ceil(C/32)] int32 bit patterns, bit c of
    word c // 32.  ``rows_per_chunk`` packs the leading axis in chunks so
    the int32 widening of a large cube stays bounded."""
    C = b.shape[-1]
    W = -(-C // 32)
    weights = torch.from_numpy(_BIT_WEIGHTS).to(b.device)

    def pack(x):
        x = torch.nn.functional.pad(x, (0, W * 32 - C))
        bits = x.reshape(*x.shape[:-1], W, 32).to(torch.int32)
        # distinct powers of two: the int32 sum is the bitwise OR
        return (bits * weights).sum(dim=-1, dtype=torch.int32)

    if rows_per_chunk is None or b.ndim < 2 or b.shape[0] <= rows_per_chunk:
        return pack(b)
    out = torch.empty((*b.shape[:-1], W), dtype=torch.int32, device=b.device)
    for r0 in range(0, b.shape[0], rows_per_chunk):
        out[r0:r0 + rows_per_chunk] = pack(b[r0:r0 + rows_per_chunk])
    return out


def unpack_bits(words: torch.Tensor, C: int | None = None) -> torch.Tensor:
    """[..., W] int32 -> [..., C] bool (inverse of ``pack_bits``)."""
    W = words.shape[-1]
    k = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> k) & 1
    out = bits.to(torch.bool).reshape(*words.shape[:-1], W * 32)
    return out if C is None else out[..., :C]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 bit pattern (SWAR), as int32."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)
