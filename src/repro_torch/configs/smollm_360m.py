"""smollm-360m [dense] — llama-arch small, GQA kv=5
(hf:HuggingFaceTB/SmolLM-360M)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab_size=49_152,
    rope_theta=10_000.0, hidden_act="silu", tie_embeddings=True,
)
