"""Mamba-2 block (SSD form), used by zamba2-1.2b (the port of
``repro.models.mamba2``).

Structure per arXiv:2405.21060: fused input projection producing
(z, x, B, C, dt), short causal depthwise conv over (x, B, C), scalar-per-head
data-dependent decay ``a_t = exp(-dt * exp(A_log))``, the SSD recurrence via
the shared chunked linear-attention core, gated output.

State per layer: (conv [B, d_conv-1, d_conv_ch], ssd [B, H, N, P]).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (COMPUTE_DTYPE, F32, _bf16, _normal,
                                       _uniform, init_rmsnorm, rmsnorm)
from repro_torch.models.linear_attn import chunked_linear_attn


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state      # x + B + C go through the conv
    return s, d_in, H, conv_ch


def init_mamba_block(cfg: ModelConfig, generator, device=None):
    s, d_in, H, conv_ch = _dims(cfg)
    d = cfg.d_model
    proj_out = 2 * d_in + 2 * s.d_state + H     # z, x, B, C, dt
    dt = _uniform((H,), generator, device, 1e-3, 0.1)
    return {
        "ln": init_rmsnorm(d, device),
        "in_proj": _normal((d, proj_out), generator, device) / math.sqrt(d),
        "conv_w": _normal((s.d_conv, conv_ch), generator, device, 0.2),
        "conv_b": torch.zeros((conv_ch,), dtype=F32, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                          device=device)),
        "D": torch.ones((H,), dtype=F32, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm": init_rmsnorm(d_in, device),
        "out_proj": _normal((d_in, d), generator, device) / math.sqrt(d_in),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv.  x: [B, L, C]; w: [K, C]; state [B, K-1, C].
    The taps add one after another in x's dtype, as the reference's do."""
    Kc = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((x.shape[0], Kc - 1, x.shape[2]),
                                 dtype=x.dtype, device=x.device)
    xp = torch.cat([conv_state, x], dim=1)
    L = x.shape[1]
    out = xp[:, 0:L] * w[0][None, None]
    for i in range(1, Kc):
        out = out + xp[:, i:i + L] * w[i][None, None]
    new_state = xp[:, -(Kc - 1):]
    return out + b[None, None], new_state


def mamba_block(p, x, cfg: ModelConfig, state=None):
    """x: [B, L, D] -> (y, new_state)."""
    B, L, D = x.shape
    s, d_in, H, conv_ch = _dims(cfg)
    P, N = s.head_dim, s.d_state
    if state is None:
        state = {
            "conv": torch.zeros((B, s.d_conv - 1, conv_ch),
                                dtype=COMPUTE_DTYPE, device=x.device),
            "ssd": torch.zeros((B, H, N, P), dtype=F32, device=x.device),
        }

    xa = rmsnorm(p["ln"], x, cfg.norm_eps)
    proj = _bf16(xa) @ _bf16(p["in_proj"])            # [B, L, proj_out]
    z, xc, Bv, Cv, dt = torch.split(proj, [d_in, d_in, N, N, H], dim=-1)

    conv_in = torch.cat([xc, Bv, Cv], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, _bf16(p["conv_w"]), _bf16(p["conv_b"]), state["conv"])
    conv_out = F.silu(conv_out)
    xc, Bv, Cv = torch.split(conv_out, [d_in, N, N], dim=-1)

    # jax.nn.softplus is logaddexp(x, 0) everywhere; F.softplus turns
    # linear above its threshold
    dtf = dt.to(F32) + p["dt_bias"][None, None]
    dt = torch.logaddexp(dtf, torch.zeros((), dtype=F32, device=x.device))
    a = -torch.exp(p["A_log"])[None, None] * dt              # log decay < 0

    # heads: x -> v [B,H,L,P]; B -> k [B,H,L,N]; C -> q
    v = xc.reshape(B, L, H, P).transpose(1, 2)
    v = v * dt.transpose(1, 2)[..., None].to(v.dtype)        # dt-scaled input
    k = torch.broadcast_to(Bv[:, None], (B, H, L, N))
    q = torch.broadcast_to(Cv[:, None], (B, H, L, N))
    ld = a.transpose(1, 2)[..., None]                        # [B,H,L,1]

    y, ssd = chunked_linear_attn(q, k, v, ld, mode="mamba",
                                 state0=state["ssd"], chunk=s.chunk)
    y = y + p["D"][None, :, None, None].to(y.dtype) * \
        xc.reshape(B, L, H, P).transpose(1, 2)               # skip path
    y = y.transpose(1, 2).reshape(B, L, d_in)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z)
    out = (_bf16(y) @ _bf16(p["out_proj"])).to(x.dtype)
    new_state = {"conv": conv_state, "ssd": ssd}
    return x + out, new_state
