"""paligemma-3b [vlm] — SigLIP (stub) + gemma decoder, MQA kv=1, prefix-LM
(arXiv:2407.07726; hf).  The modality frontend is a STUB: input_specs()
provides precomputed patch embeddings [B, 256, 1152]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    head_dim=256, d_ff=16_384, vocab_size=257_216,
    rope_theta=10_000.0, hidden_act="gelu", tie_embeddings=True,
    embed_scale=True,
    frontend="siglip_stub", vision_tokens=256, d_vision=1152,
)
