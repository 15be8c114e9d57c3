"""yi-6b [dense] — llama-arch GQA kv=4 (arXiv:2403.04652; hf)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab_size=64_000,
    rope_theta=5_000_000.0, hidden_act="silu",
)
