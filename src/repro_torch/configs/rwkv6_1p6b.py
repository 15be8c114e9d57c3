"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free
(arXiv:2404.05892)."""
from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # heads = d/64
    d_ff=7168, vocab_size=65_536,
    hidden_act="silu",
    rwkv=RWKVConfig(head_dim=64, lora_w=64, lora_mix=32, chunk=64),
    subquadratic=True,
)
