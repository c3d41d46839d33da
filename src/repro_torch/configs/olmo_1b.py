"""olmo-1b [dense] — 16L d2048 16H MHA ff8192 vocab=50304.
Non-parametric LayerNorm.  [arXiv:2402.00838; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm="nonparam_ln", tie_embeddings=True,
)
