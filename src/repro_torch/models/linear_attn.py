"""Chunked linear attention with per-step decay, the shared core of RWKV-6
(Finch) and Mamba-2 (SSD) (the port of ``repro.models.linear_attn``).

Both recurrences are instances of

    S_t = diag(exp(ld_t)) . S_{t-1} + k_t v_t^T          (state [K, V])
    mamba mode:  y_t = q_t . S_t
    rwkv  mode:  y_t = q_t . (S_{t-1} + (u (.) k_t) v_t^T)

The chunked form processes Q-step chunks with dense matmuls (intra-chunk
via cumulative log-decay differences, inter-chunk via the carried state);
a Python loop over the chunks replaces the reference's ``lax.scan``.  The
state is carried in f32 and every product keeps the reference's dtype.

Numerical note: intra-chunk factors use exponents relative to the chunk
start, clamped at +-CLAMP; pairs whose true factor underflows are ~0 anyway.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CLAMP = 25.0
F32 = torch.float32


def _chunk_scan(q, k, v, ld, u, mode: str, state0, chunk: int):
    """q,k: [B,H,L,K]; v: [B,H,L,V]; ld: [B,H,L,K] (or broadcastable);
    state0: [B,H,K,V].  Returns (y [B,H,L,V], state [B,H,K,V])."""
    B, H, L, K = q.shape
    V = v.shape[-1]
    assert L % chunk == 0, (L, chunk)
    n = L // chunk

    qc = q.reshape(B, H, n, chunk, K)
    kc = k.reshape(B, H, n, chunk, K)
    vc = v.reshape(B, H, n, chunk, V)
    ldc = torch.broadcast_to(ld, (B, H, L, K)).reshape(B, H, n, chunk, K)
    ldc = ldc.to(F32)

    # inclusive cumulative log-decay within each chunk
    csum = torch.cumsum(ldc, dim=3)                    # [B,H,n,Q,K]
    total = csum[..., -1, :]                           # [B,H,n,K]

    # factors relative to chunk start
    q_fac = csum if mode == "mamba" else csum - ldc    # c_i vs c_{i-1}
    qs = qc * torch.exp(torch.clamp(q_fac, -CLAMP, CLAMP)).to(qc.dtype)
    ks = kc * torch.exp(torch.clamp(-csum, -CLAMP, CLAMP)).to(kc.dtype)

    # intra-chunk attention
    att = torch.einsum("bhnik,bhnjk->bhnij", qs, ks)   # [B,H,n,Q,Q]
    ii = torch.arange(chunk, device=q.device)
    if mode == "mamba":
        m = ii[:, None] >= ii[None, :]
    else:
        m = ii[:, None] > ii[None, :]
    att = torch.where(m[None, None, None], att, torch.zeros((), dtype=att.dtype,
                                                            device=att.device))
    y_intra = torch.einsum("bhnij,bhnjv->bhniv", att, vc)
    if mode == "rwkv":
        bonus = torch.einsum("bhnik,bhniv->bhniv",
                             qc * (u[None, :, None, None, :] * kc), vc)
        y_intra = y_intra + bonus

    # inter-chunk: carry the state over the chunks
    k_tail = kc * torch.exp(torch.clamp(total[..., None, :] - csum,
                                        -CLAMP, CLAMP)).to(kc.dtype)
    S = state0.to(F32)
    y_state = []
    # the chunks unbound once: the backward stacks their gradients once,
    # where indexing each chunk apart adds a zero tensor of the whole
    for qs_i, tot_i, kt_i, vc_i in zip(qs.unbind(2), total.unbind(2),
                                       k_tail.unbind(2), vc.unbind(2)):
        y_state.append(torch.einsum("bhik,bhkv->bhiv", qs_i,
                                    S.to(qs_i.dtype)))
        S = (S * torch.exp(torch.clamp(tot_i, -CLAMP, CLAMP))[..., None]
             + torch.einsum("bhik,bhiv->bhkv", kt_i, vc_i).to(F32))
    y = y_intra + torch.stack(y_state, dim=2)
    return y.reshape(B, H, L, V), S


def chunked_linear_attn(q, k, v, log_decay, *, mode: str = "mamba",
                        u=None, state0=None, chunk: int = 64):
    """Public entry.  Pads L to a chunk multiple; see module docstring."""
    B, H, L, K = q.shape
    V = v.shape[-1]
    if state0 is None:
        state0 = torch.zeros((B, H, K, V), dtype=F32, device=q.device)
    pad = (-L) % chunk
    if pad:
        def zq(a):
            return F.pad(a, (0, 0, 0, pad))
        q, k, v = zq(q), zq(k), zq(v)
        log_decay = zq(torch.broadcast_to(log_decay, (B, H, L, K)))
    if u is None:
        u = torch.zeros((H, K), dtype=q.dtype, device=q.device)
    y, state = _chunk_scan(q, k, v, log_decay, u, mode, state0, chunk)
    return y[:, :, :L], state


def linear_attn_step(q, k, v, log_decay, state, *, mode="mamba", u=None):
    """Single decode step.  q,k: [B,H,K]; v: [B,H,V]; state [B,H,K,V]."""
    a = torch.exp(log_decay.to(F32))                    # [B,H,K] or [B,H,1]
    kv = torch.einsum("bhk,bhv->bhkv", k, v).to(F32)
    if mode == "mamba":
        state = state * a[..., None] + kv
        y = torch.einsum("bhk,bhkv->bhv", q, state.to(q.dtype))
    else:
        mix = state + (u[None] * k).to(F32)[..., None] * \
            v.to(F32)[..., None, :]
        y = torch.einsum("bhk,bhkv->bhv", q, mix.to(q.dtype))
        state = state * a[..., None] + kv
    return y, state


def naive_scan_ref(q, k, v, log_decay, *, mode="mamba", u=None, state0=None):
    """O(L) sequential oracle used by tests."""
    B, H, L, K = q.shape
    V = v.shape[-1]
    if state0 is None:
        state0 = torch.zeros((B, H, K, V), dtype=F32, device=q.device)
    if u is None:
        u = torch.zeros((H, K), dtype=q.dtype, device=q.device)
    ld = torch.broadcast_to(log_decay, (B, H, L, K))
    S, ys = state0, []
    for t in range(L):
        y, S = linear_attn_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                ld[:, :, t], S, mode=mode, u=u)
        ys.append(y)
    return torch.stack(ys, dim=2), S
