"""zamba2-1.2b [hybrid] — Mamba-2 backbone + shared attention block
(arXiv:2411.15242; hf).  ssm_state=64; one shared attn+mlp block applied
every 6 mamba layers (weight-shared, zamba2-style)."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_000,
    hidden_act="gelu",
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=64),
    attn_every=6,
    subquadratic=True,
)
