"""gemma2-2b [dense] — local+global alternating attention, logit softcaps,
pre+post norms (arXiv:2408.00118; hf)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    head_dim=256, d_ff=9216, vocab_size=256_000,
    rope_theta=10_000.0, hidden_act="gelu", tie_embeddings=True,
    attn_softcap=50.0, final_softcap=30.0,
    sliding_window=4096, local_global=True, gemma_norms=True,
    embed_scale=True, query_scale=256 ** -0.5,
    # half the layers are 4k sliding-window; global-layer KV is
    # sequence-shardable -> long_500k decode is admissible
    subquadratic=True,
)
