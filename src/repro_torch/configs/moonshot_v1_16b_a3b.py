"""moonshot-v1-16b-a3b [moe] — kimi/moonlight: 64 routed experts top-6,
2 shared, first layer dense (hf:moonshotai/Moonlight-16B-A3B)."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab_size=163_840,
    rope_theta=50_000.0, hidden_act="silu",
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  first_k_dense=1),
)
