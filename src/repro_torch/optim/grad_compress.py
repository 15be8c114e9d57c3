"""Error-feedback gradient compression for the DP all-reduce (the port of
``repro.optim.grad_compress``).

Two compressors, both with error feedback (the residual between the true
and the compressed gradient is carried in optimizer-side state and added
back the next step, preserving convergence):

  int8   — per-leaf symmetric quantization: the all-reduce moves 1/4 the
           bytes (int8 payload + one f32 scale per leaf).
  topk   — per-leaf magnitude top-k (k = ratio * size): the all-reduce moves
           values+indices of the k survivors.

Trees are nested dicts of tensors (a ``ParamTree`` reads as its nested
dict); a payload keeps the tree, each leaf a tuple.  ``torch.round``
rounds half to even, as ``jnp.round`` does, and the top-k takes equal
magnitudes in ascending index order, as ``lax.top_k`` does (a stable
descending sort; ``torch.topk`` promises no tie order).
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import _tree

F32 = torch.float32


def _map(fn, *trees):
    """``fn`` over the leaves of same-structured dict trees."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    return fn(*trees)


def _split(tree, n: int):
    """A tree of n-tuples as n trees."""
    if isinstance(tree, dict):
        parts = {k: _split(v, n) for k, v in tree.items()}
        return tuple({k: p[i] for k, p in parts.items()} for i in range(n))
    return tree


def ef_init(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
                _tree(params))


def _quantize_int8(g):
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q, scale):
    return q.to(F32) * scale


def compress_int8(grads, ef_state):
    """Returns (payload tree of ``(q, scale)`` to all-reduce, new
    residuals)."""
    def one(g, e):
        g32 = g.to(F32) + e
        q, s = _quantize_int8(g32)
        return (q, s), g32 - _dequantize_int8(q, s)
    return _split(_map(one, _tree(grads), ef_state), 2)


def decompress_int8(payload):
    return _map(lambda t: _dequantize_int8(*t), payload)


def _top_k(x, k: int):
    """``lax.top_k`` of a vector: the k largest, equal values in ascending
    index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def compress_topk(grads, ef_state, ratio: float = 0.05):
    """Returns (payload tree of ``(kept, idx int32, n)``, new residuals)."""
    def one(g, e):
        g32 = g.to(F32) + e
        flatg = g32.reshape(-1)
        k = max(1, int(flatg.shape[0] * ratio))
        _, idx = _top_k(torch.abs(flatg), k)
        kept = flatg[idx]
        sparse = torch.zeros_like(flatg)
        sparse[idx] = kept
        return (kept, idx.to(torch.int32), flatg.shape[0]), \
            (flatg - sparse).reshape(g.shape)
    return _split(_map(one, _tree(grads), ef_state), 2)


def decompress_topk(payload, shapes):
    def one(t, shape):
        kept, idx, n = t
        out = torch.zeros((n,), dtype=F32, device=kept.device)
        out[idx.long()] = kept
        return out.reshape(shape)
    return _map(one, payload, shapes)
