"""mamba2-130m [ssm] — 24L d768, attention-free, SSD state=128.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import MAMBA, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    layer_pattern=(MAMBA,),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
)
