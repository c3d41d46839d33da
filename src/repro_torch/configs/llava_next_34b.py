"""llava-next-34b [vlm] — 60L d7168 56H (GQA kv=8) ff20480 vocab=64000.

AnyRes tiling frontend is a STUB per the assignment: ``input_specs``
provides precomputed patch embeddings (CLIP-ViT-L dim 1024); the backbone
(Yi-34B-class decoder) is fully modeled.  [hf:llava-hf/llava-v1.6; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    rope_theta=5_000_000.0,
    vision_tokens=576,            # base-res grid; anyres adds up to 4 tiles
    frontend_dim=1024,
)
