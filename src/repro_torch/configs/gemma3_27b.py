"""gemma3-27b [dense] — 62L d5376 32H (kv=16) ff21504 vocab=262144.
5:1 local:global attention, 128k context.  [hf:google/gemma-3; unverified]
62 = 10 x (5 local + 1 global) + 2-layer local tail."""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16,
    d_ff=21504, vocab_size=262144, head_dim=128,
    layer_pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,), sliding_window=1024,
    rope_theta=1_000_000.0,
    mlp="geglu", tie_embeddings=True,
)
