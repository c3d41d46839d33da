"""gemma2-27b [dense] — 46L d4608 32H (kv=16) ff36864 vocab=256000.
Local+global alternating attention, logit softcaps.  [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL), sliding_window=4096,
    logit_softcap=30.0, attn_softcap=50.0,
    mlp="geglu", tie_embeddings=True,
)
