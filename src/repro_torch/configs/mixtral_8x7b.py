"""mixtral-8x7b [moe] — 32L d4096 32H (GQA kv=8) ff14336 vocab=32000.
8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000, head_dim=128,
    layer_pattern=(ATTN_LOCAL,), sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
)
