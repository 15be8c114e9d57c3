"""musicgen-large [audio] — decoder-only over EnCodec tokens
(arXiv:2306.05284; hf).  The EnCodec frontend is a STUB: input tokens are
4 parallel codebooks [B, 4, L], embeddings summed, 4 output heads."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    rope_theta=10_000.0, hidden_act="gelu",
    frontend="encodec_stub", n_codebooks=4,
)
