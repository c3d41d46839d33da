"""zamba2-2.7b [hybrid] — 54L d2560, Mamba2 backbone + shared attention
block, ssm_state=64.  54 = 9 x (5 mamba + 1 shared-attn); the attention
block's weights are shared across all 9 applications (the zamba2 design).
[arXiv:2411.15242; hf]"""
from repro_torch.configs.base import MAMBA, SHARED_ATTN, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    layer_pattern=(MAMBA,) * 5 + (SHARED_ATTN,),
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
)
