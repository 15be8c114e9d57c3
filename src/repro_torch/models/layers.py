"""Shared transformer building blocks (the port of ``repro.models.layers``).

Every block is a pair of functions: ``init_*(cfg, generator, device) ->
params`` and ``apply(params, x, ...) -> y``.  Parameters are nested dicts
of tensors named as the reference's tree, so a tree converted from the
reference (``models/convert.py``) runs here unchanged.

Compute dtype is bf16, parameters and reductions f32, as in the
reference.  Where the reference multiplies a bf16 array by a Python float,
JAX first rounds the float to bf16 (a weak type); ``_scalar`` does the
same here, so such products round at the same point.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16
F32 = torch.float32


def _normal(shape, generator, device, scale=1.0):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=F32) * scale


def _uniform(shape, generator, device, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=generator, device=device, dtype=F32)
    return u * (hi - lo) + lo


def _dense_init(shape, generator, device, scale=None):
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _normal(shape, generator, device, scale)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as the reference's weak type meets ``like``: cast to
    its dtype first (bf16 products then round as JAX's do)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(COMPUTE_DTYPE)


# ----------------------------- norms ----------------------------------------

def init_rmsnorm(d, device=None):
    return {"scale": torch.zeros((d,), dtype=F32, device=device)}


def rmsnorm(p, x, eps=1e-6, unit_offset=True):
    dt = x.dtype
    x = x.to(F32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    scale = (1.0 + p["scale"]) if unit_offset else p["scale"]
    return (x * scale).to(dt)


# ----------------------------- rope ------------------------------------------

def rope(x, positions, theta=10_000.0):
    """x: [..., L, H, hd]; positions: [..., L]."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=F32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=F32, device=x.device), exps)
    ang = positions[..., :, None, None].to(F32) * freq     # [..., L, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------- attention -------------------------------------

def init_attention(cfg: ModelConfig, generator, device=None):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": _dense_init((d, cfg.n_heads, hd), generator, device),
        "wk": _dense_init((d, cfg.n_kv_heads, hd), generator, device),
        "wv": _dense_init((d, cfg.n_kv_heads, hd), generator, device),
        "wo": _dense_init((cfg.n_heads, hd, d), generator, device),
    }


def _softcap(x, cap):
    c = _scalar(cap, x)
    return c * torch.tanh(x / c)


ATTN_Q_CHUNK = 512
ATTN_KV_CHUNK = 1024
ATTN_CHUNK_THRESHOLD = 2048   # use online-softmax path when L_q > this


def _mask_block(q_pos, kv_pos, sliding_window, prefix_len, max_kv):
    """[Lq, Lkv] bool mask from position vectors (causal/window/prefix)."""
    causal = kv_pos[None, :] <= q_pos[:, None]
    if prefix_len is not None:
        bidir = (kv_pos[None, :] < prefix_len) & (q_pos[:, None] < prefix_len)
        causal = causal | bidir
    if sliding_window is not None:
        causal &= kv_pos[None, :] > (q_pos[:, None] - sliding_window)
    if max_kv is not None:
        causal &= kv_pos[None, :] <= max_kv
    return causal


def _attend_dense(qg, k, v, q_pos, kv_pos, cfg, sliding_window, prefix_len,
                  max_kv):
    """Reference path: materializes [B, Lq, KV, G, M] logits."""
    logits = torch.einsum("blkgh,bmkh->blkgm", qg, k)
    if cfg.attn_softcap is not None:
        logits = _softcap(logits, cfg.attn_softcap)
    mask = _mask_block(q_pos, kv_pos, sliding_window, prefix_len, max_kv)
    logits = torch.where(mask[None, :, None, None, :], logits.to(F32),
                         -1e30)
    probs = torch.softmax(logits, dim=-1).to(qg.dtype)
    return torch.einsum("blkgm,bmkh->blkgh", probs, v)


def _kv_step(m, l, acc, qi, kj, vj, qp, kvp, cfg, sliding_window,
             prefix_len, max_kv):
    """One KV chunk of the online softmax: the running (max, denom, acc)
    after chunk ``kj`` / ``vj``."""
    logits = torch.einsum("bqkgh,bmkh->bqkgm", qi, kj)
    if cfg.attn_softcap is not None:
        logits = _softcap(logits, cfg.attn_softcap)
    msk = _mask_block(qp, kvp, sliding_window, prefix_len, max_kv)
    logits = torch.where(msk[None, :, None, None, :], logits.to(F32), -1e30)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    scale_old = torch.exp(m - m_new)
    p_blk = torch.exp(logits - m_new[..., None])
    l = l * scale_old + p_blk.sum(dim=-1)
    pv = torch.einsum("bqkgm,bmkh->bqkgh", p_blk.to(qi.dtype), vj)
    acc = acc * scale_old[..., None] + pv
    return m_new, l, acc


# ``depth`` is non-zero while this thread runs a checkpointed KV step: a
# selective checkpoint around the layer ("dots", ``transformer._remat``)
# saves nothing inside it, as ``dots_saveable`` sees nothing inside the
# reference's ``jax.checkpoint(kv_step)`` (it would otherwise keep every
# chunk's logits for the backward)
KV_STEP = threading.local()


def in_kv_step() -> bool:
    return getattr(KV_STEP, "depth", 0) > 0


def _kv_step_checkpointed(*args):
    KV_STEP.depth = getattr(KV_STEP, "depth", 0) + 1
    try:
        return _kv_step(*args)
    finally:
        KV_STEP.depth -= 1


def _attend_online(qg, k, v, q_pos, kv_pos, cfg, sliding_window, prefix_len,
                   max_kv):
    """Online softmax, as the reference's: query chunks in turn, each over
    the KV chunks with a running (max, denom, acc), peak memory O(q chunk
    x kv chunk).  The chunk sizes halve from ATTN_Q_CHUNK / ATTN_KV_CHUNK
    until they divide the lengths, as the reference's do: another
    chunking is another order of float operations.  While autograd
    records, each KV step is checkpointed, as the reference's
    ``jax.checkpoint(kv_step)``: the backward keeps the carried
    (m, l, acc) of each step, not its f32 logits and probabilities."""
    B, Lq, KV, G, hd = qg.shape
    M = k.shape[1]
    qc, kc = ATTN_Q_CHUNK, ATTN_KV_CHUNK
    qc = min(qc, Lq)
    while Lq % qc:
        qc //= 2
    kc = min(kc, M)
    while M % kc:
        kc //= 2
    nq, nk = Lq // qc, M // kc
    step = _kv_step
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, _kv_step_checkpointed,
                                 use_reentrant=False)
    outs = []
    for i in range(nq):
        qi = qg[:, i * qc:(i + 1) * qc]              # [B, qc, KV, G, hd]
        qp = q_pos[i * qc:(i + 1) * qc]
        m = torch.full((B, qc, KV, G), -1e30, dtype=F32, device=qg.device)
        l = torch.zeros((B, qc, KV, G), dtype=F32, device=qg.device)
        acc = torch.zeros((B, qc, KV, G, hd), dtype=F32, device=qg.device)
        for j in range(nk):
            m, l, acc = step(m, l, acc, qi, k[:, j * kc:(j + 1) * kc],
                             v[:, j * kc:(j + 1) * kc],
                             qp, kv_pos[j * kc:(j + 1) * kc], cfg,
                             sliding_window, prefix_len, max_kv)
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.cat(outs, dim=1).to(qg.dtype)


def attention(p, x, cfg: ModelConfig, positions, *, mask=None,
              cache: Optional[dict] = None, cache_index=None,
              sliding_window: Optional[int] = None,
              prefix_len: Optional[int] = None):
    """GQA attention with RoPE, an optional KV cache, softcap, sliding
    window and prefix-LM (bidirectional prefix) masking.

    x: [B, L, D].  With ``cache`` given, k / v of the L new positions are
    written into it in place at ``cache_index`` (cache layout: k/v
    [B, L_max, KV, hd]) and the queries attend over the whole cache up to
    ``cache_index + L - 1``.  Long sequences take the online-softmax path.
    Returns (out, new_cache); ``new_cache`` is ``cache`` itself.
    """
    del mask
    B, L, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    xc = _bf16(x)

    q = torch.einsum("bld,dhk->blhk", xc, _bf16(p["wq"]))
    k = torch.einsum("bld,dhk->blhk", xc, _bf16(p["wk"]))
    v = torch.einsum("bld,dhk->blhk", xc, _bf16(p["wv"]))

    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = cfg.query_scale if cfg.query_scale is not None else hd ** -0.5
    q = q * _scalar(scale, q)

    q_pos = positions
    if cache is not None:
        ci = int(cache_index)
        cache["k"][:, ci:ci + L] = k.to(cache["k"].dtype)
        cache["v"][:, ci:ci + L] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
        new_cache = cache
        kv_positions = torch.arange(k.shape[1], dtype=torch.int32,
                                    device=x.device)
        q_pos = ci + torch.arange(L, dtype=torch.int32, device=x.device)
        max_kv = ci + L - 1
    else:
        new_cache = None
        kv_positions = positions
        max_kv = None

    G = H // KV
    qg = q.reshape(B, L, KV, G, hd)
    if L > ATTN_CHUNK_THRESHOLD:
        out = _attend_online(qg, k, v, q_pos, kv_positions, cfg,
                             sliding_window, prefix_len, max_kv)
    else:
        out = _attend_dense(qg, k, v, q_pos, kv_positions, cfg,
                            sliding_window, prefix_len, max_kv)

    out = _bf16(out.reshape(B, L, H, hd))
    out = torch.einsum("blhk,hkd->bld", out, _bf16(p["wo"]))
    return out.to(x.dtype), new_cache


# ----------------------------- mlp -------------------------------------------

def init_mlp(d, d_ff, generator, device=None):
    return {
        "wi_gate": _dense_init((d, d_ff), generator, device),
        "wi_up": _dense_init((d, d_ff), generator, device),
        "wo": _dense_init((d_ff, d), generator, device),
    }


def mlp(p, x, act="silu"):
    xc = _bf16(x)
    g = xc @ _bf16(p["wi_gate"])
    u = xc @ _bf16(p["wi_up"])
    if act == "silu":
        h = F.silu(g) * u
    elif act == "gelu":
        h = F.gelu(g, approximate="tanh") * u
    else:
        raise ValueError(act)
    out = h @ _bf16(p["wo"])
    return out.to(x.dtype)


# ----------------------------- embeddings ------------------------------------

def init_embedding(vocab, d, generator, device=None):
    return {"table": _normal((vocab, d), generator, device, 0.02)}


def embed(p, tokens, scale_by_sqrt_d=False):
    x = F.embedding(tokens.long(), _bf16(p["table"]))
    if scale_by_sqrt_d:
        x = x * _scalar(p["table"].shape[1] ** 0.5, x)
    return x


def unembed(p, x, tied_table=None, final_softcap=None):
    table = (tied_table if tied_table is not None else p["table"])
    logits = (_bf16(x) @ _bf16(table).T).to(F32)
    if final_softcap is not None:
        logits = _softcap(logits, final_softcap)
    return logits
