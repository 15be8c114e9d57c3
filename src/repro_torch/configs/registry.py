"""Architecture & shape registry (the port's copy of
``repro.configs.registry``): the LM architectures, their shapes and the
reduced configs of the CPU tests, and the DSC run configurations.

Shapes (LM-family, per the assignment):
    train_4k     seq 4096,    global_batch 256   (training;   train_step)
    prefill_32k  seq 32768,   global_batch 32    (inference;  prefill)
    decode_32k   seq 32768,   global_batch 128   (decode: 1 new token w/ cache)
    long_500k    seq 524288,  global_batch 1     (long-context decode;
                                                  sub-quadratic archs only)
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import (ModelConfig, MoEConfig, RWKVConfig,
                                       SSMConfig)

_ARCH_MODULES = {
    "deepseek-7b": "repro_torch.configs.deepseek_7b",
    "smollm-360m": "repro_torch.configs.smollm_360m",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1p6b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}
ARCHITECTURES = list(_ARCH_MODULES)

SHAPES = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32_768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32_768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524_288, "global_batch": 1, "kind": "decode"},
}


def get_arch(name: str) -> ModelConfig:
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def shape_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (DESIGN.md §5)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k dense KV decode is "
                       "out of spec (skip noted in DESIGN.md §5)")
    return True, ""


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    updates = dict(
        n_layers=2 if not cfg.attn_every else 4,
        d_model=64,
        n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16, d_ff=128, vocab_size=256,
        vision_tokens=8, d_vision=32,
        sliding_window=8 if cfg.sliding_window else None,
    )
    if cfg.moe is not None:
        # high capacity factor -> no token drops, so smoke tests exercise
        # routing/cache correctness deterministically
        updates["moe"] = MoEConfig(
            n_experts=8, top_k=2, d_expert=32,
            n_shared=min(cfg.moe.n_shared, 1),
            first_k_dense=min(cfg.moe.first_k_dense, 1),
            capacity_factor=8.0)
    if cfg.ssm is not None:
        updates["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2,
                                   head_dim=16, chunk=8)
        updates["attn_every"] = 2
    if cfg.rwkv is not None:
        updates["rwkv"] = RWKVConfig(head_dim=16, lora_w=8, lora_mix=8,
                                     chunk=8)
    return dataclasses.replace(cfg, **updates)


# ------------------------- DSC (the paper's own) configs --------------------

@dataclasses.dataclass(frozen=True)
class DSCRunConfig:
    """A DSC pipeline sizing (dataset capacities + parameters)."""
    name: str
    n_trajs: int          # T (row capacity, all partitions)
    max_points: int       # Mp per partition
    n_partitions_hint: int
    eps_sp: float = 0.1
    eps_t: float = 1.0
    delta_t: float = 0.0
    w: int = 10
    tau: float = 0.4
    alpha_sigma: float = 0.0
    k_sigma: float = 0.0
    max_subtrajs: int = 8
    segmentation: str = "tsa1"


DSC_CONFIGS = {
    # synthetic ground-truth scenario (Sec. 6.2)
    "dsc_synth": DSCRunConfig(name="dsc_synth", n_trajs=256, max_points=64,
                              n_partitions_hint=16),
    # Brest AIS-scale: 3.65e5 trajs, 17e6 points -> per-pod slice
    "dsc_brest": DSCRunConfig(name="dsc_brest", n_trajs=4096, max_points=128,
                              n_partitions_hint=32, w=20),
    # SIS urban-scale: 2.2e7 trajs, 7.2e8 points -> per-pod slice
    "dsc_sis": DSCRunConfig(name="dsc_sis", n_trajs=8192, max_points=128,
                            n_partitions_hint=32, w=20),
}


def get_dsc_config(name: str) -> DSCRunConfig:
    return DSC_CONFIGS[name]
