"""RWKV-6 (Finch) block: data-dependent-decay time mix + channel mix (the
port of ``repro.models.rwkv6``).

Per arXiv:2404.05892: token-shift ddlerp mixing with a low-rank (LoRA)
data-dependent part for the five mix vectors, a LoRA'd data-dependent
per-channel decay ``w``, the u-bonus WKV recurrence through the shared
chunked linear-attention core, and the squared-ReLU channel mix.

State per layer: (shift_tm [B, D], shift_cm [B, D], wkv [B, H, K, K]).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (F32, _bf16, _normal, _uniform,
                                       init_rmsnorm, rmsnorm)
from repro_torch.models.linear_attn import chunked_linear_attn


def init_rwkv_block(cfg: ModelConfig, generator, device=None):
    d = cfg.d_model
    r = cfg.rwkv
    s = 1.0 / math.sqrt(d)
    H = d // r.head_dim

    def nrm(shape, scale):
        return _normal(shape, generator, device, scale)

    p = {
        "ln_tm": init_rmsnorm(d, device), "ln_cm": init_rmsnorm(d, device),
        # ddlerp base mixes (5: r, k, v, w, g) + LoRA
        "mix_base": _uniform((5, d), generator, device),
        "mix_lora_a": nrm((d, r.lora_mix), s),
        "mix_lora_b": nrm((5, r.lora_mix, d), 0.01),
        "mix_first": _uniform((d,), generator, device),
        # projections
        "wr": nrm((d, d), s),
        "wk": nrm((d, d), s),
        "wv": nrm((d, d), s),
        "wg": nrm((d, d), s),
        "wo": nrm((d, d), s),
        # decay: w = exp(-exp(w0 + lora(x)))
        "w0": torch.full((d,), -2.0, dtype=F32, device=device)
        + nrm((d,), 0.1),
        "w_lora_a": nrm((d, r.lora_w), s),
        "w_lora_b": nrm((r.lora_w, d), 0.01),
        "u": nrm((H, r.head_dim), 0.1),
        "ln_x": init_rmsnorm(d, device),
        # channel mix
        "cm_mix": _uniform((2, d), generator, device),
        "cm_k": nrm((d, cfg.d_ff), s),
        "cm_v": nrm((cfg.d_ff, d), 1.0 / math.sqrt(cfg.d_ff)),
    }
    # the reference draws cm_r from wg's key, so the two start equal
    p["cm_r"] = p["wg"].clone()
    return p


def _shift(x, shift_state):
    """Token shift: x_prev[t] = x[t-1]; position 0 reads the carried state.
    x: [B, L, D]; shift_state: [B, D] -> (x_prev, new_state)."""
    prev = torch.cat([shift_state[:, None], x[:, :-1]], dim=1)
    return prev, x[:, -1]


def rwkv_block(p, x, cfg: ModelConfig, state=None):
    """x: [B, L, D].  state: dict(shift_tm, shift_cm, wkv) or None.
    Returns (y, new_state)."""
    B, L, D = x.shape
    r = cfg.rwkv
    H, K = D // r.head_dim, r.head_dim
    if state is None:
        state = {
            "shift_tm": torch.zeros((B, D), dtype=x.dtype, device=x.device),
            "shift_cm": torch.zeros((B, D), dtype=x.dtype, device=x.device),
            "wkv": torch.zeros((B, H, K, K), dtype=F32, device=x.device),
        }

    # ---- time mix ----
    xa = rmsnorm(p["ln_tm"], x, cfg.norm_eps)
    prev, tm_last = _shift(xa, state["shift_tm"])
    dx = prev - xa
    mix_x = xa + dx * p["mix_first"][None, None]
    lora = torch.tanh(_bf16(mix_x) @ _bf16(p["mix_lora_a"]))
    dyn = torch.einsum("blr,srd->sbld", lora, _bf16(p["mix_lora_b"]))
    mixes = _bf16(p["mix_base"][:, None, None, :]) + dyn
    xr, xk, xv, xw, xg = [xa + dx * m for m in mixes.unbind(0)]

    rq = _bf16(xr) @ _bf16(p["wr"])
    kk = _bf16(xk) @ _bf16(p["wk"])
    vv = _bf16(xv) @ _bf16(p["wv"])
    gg = F.silu(_bf16(xg) @ _bf16(p["wg"]))

    wl = torch.tanh(_bf16(xw) @ _bf16(p["w_lora_a"])) @ _bf16(p["w_lora_b"])
    log_w = -torch.exp(torch.clamp(p["w0"][None, None].to(F32)
                                   + wl.to(F32), -8.0, 2.0))  # [B, L, D] (<0)

    def heads(a):
        return a.reshape(B, L, H, K).transpose(1, 2)

    y, wkv = chunked_linear_attn(
        heads(rq), heads(kk), heads(vv), heads(log_w), mode="rwkv",
        u=_bf16(p["u"]), state0=state["wkv"], chunk=r.chunk)
    y = y.transpose(1, 2).reshape(B, L, D)
    y = rmsnorm(p["ln_x"], y, cfg.norm_eps) * gg
    y = (y @ _bf16(p["wo"])).to(x.dtype)
    x = x + y

    # ---- channel mix ----
    xb = rmsnorm(p["ln_cm"], x, cfg.norm_eps)
    prev_c, cm_last = _shift(xb, state["shift_cm"])
    dxc = prev_c - xb
    xk2 = xb + dxc * p["cm_mix"][0][None, None]
    xr2 = xb + dxc * p["cm_mix"][1][None, None]
    kcm = torch.square(F.relu(_bf16(xk2) @ _bf16(p["cm_k"])))
    vcm = kcm @ _bf16(p["cm_v"])
    gate = torch.sigmoid(_bf16(xr2) @ _bf16(p["cm_r"]))
    x = x + (vcm * gate).to(x.dtype)

    new_state = {"shift_tm": tm_last.to(x.dtype),
                 "shift_cm": cm_last.to(x.dtype), "wkv": wkv}
    return x, new_state
