"""Unified model configuration covering all 10 assigned architectures (the
port's copy of ``repro.models.config``)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int          # routed experts
    top_k: int
    d_expert: int           # per-expert FFN hidden size
    n_shared: int = 0       # always-on shared experts
    first_k_dense: int = 0  # leading dense layers (DeepSeek/Moonlight style)
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25
    quantize_dispatch: bool = False   # int8 EP all_to_all payload


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64       # N (per-head state dim)
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64      # P (channels per head); heads = expand*d/head_dim
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_w: int = 64        # decay LoRA rank
    lora_mix: int = 32      # token-mix ddlerp LoRA rank
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str             # dense | moe | rwkv | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    hidden_act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU)
    tie_embeddings: bool = False
    # gemma-2 specifics
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    sliding_window: Optional[int] = None    # local-attention window
    local_global: bool = False              # alternate local/global layers
    gemma_norms: bool = False               # (1+g) RMSNorm + post-norms
    embed_scale: bool = False               # multiply embeddings by sqrt(d)
    query_scale: Optional[float] = None
    # mixtures / ssm / rwkv
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    attn_every: Optional[int] = None        # hybrid: shared attn each k layers
    # multimodal frontends (stubs per the brief)
    frontend: Optional[str] = None          # siglip_stub | encodec_stub
    vision_tokens: int = 256
    d_vision: int = 1152
    n_codebooks: int = 1
    # sub-quadratic flag (decides long_500k eligibility)
    subquadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.moe is not None:
            e = self.moe
            ff_routed = 3 * d * e.d_expert * e.n_experts
            ff_shared = 3 * d * e.d_expert * e.n_shared
            router = d * e.n_experts
            dense_ff = 3 * d * self.d_ff
            n_moe = self.n_layers - e.first_k_dense
            ff_total = (n_moe * (ff_routed + ff_shared + router)
                        + e.first_k_dense * dense_ff)
        else:
            ff_total = self.n_layers * 3 * d * self.d_ff
        if self.rwkv is not None:
            # r,k,v,g,o (d*d each) + decay/mix loras + channel-mix (2 mats)
            tm = (5 * d * d + 2 * d * self.rwkv.lora_w
                  + 2 * 5 * d * self.rwkv.lora_mix)
            cm = d * self.d_ff + self.d_ff * d
            core = self.n_layers * (tm + cm)
        elif self.ssm is not None:
            s = self.ssm
            d_in = s.expand * d
            heads = d_in // s.head_dim
            per_mamba = (d * (2 * d_in + 2 * s.d_state + heads) + d_in * d
                         + s.d_conv * (d_in + 2 * s.d_state))
            core = self.n_layers * per_mamba
            if self.attn_every:   # one SHARED attn+mlp block (zamba2-style)
                core += attn + 3 * d * self.d_ff
        else:
            core = self.n_layers * attn + ff_total
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.frontend == "encodec_stub":
            embed *= max(1, self.n_codebooks)
        return int(core + embed)

    def active_param_count(self) -> int:
        """Active (per-token) parameters — the MoE 6*N_active*D factor."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        e = self.moe
        attn = (d * (self.n_heads * self.resolved_head_dim)
                + 2 * d * (self.n_kv_heads * self.resolved_head_dim)
                + (self.n_heads * self.resolved_head_dim) * d)
        ff_active = 3 * d * e.d_expert * (e.top_k + e.n_shared)
        n_moe = self.n_layers - e.first_k_dense
        core = (self.n_layers * attn + n_moe * ff_active
                + e.first_k_dense * 3 * d * self.d_ff)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(core + embed)
