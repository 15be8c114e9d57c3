"""qwen2-moe-a2.7b [moe] — 60 routed top-4 + 4 shared experts
(hf:Qwen/Qwen1.5-MoE-A2.7B)."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=5632, vocab_size=151_936,
    rope_theta=1_000_000.0, hidden_act="silu",
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408, n_shared=4,
                  first_k_dense=0),
)
