"""llama4-maverick-400b-a17b [moe] — 48L d5120 40H (GQA kv=8) expert-ff 8192
vocab=202048, MoE 128 experts top-1 + shared expert, MoE every other layer
(interleaved dense FFN).  Early-fusion frontend stubbed (text path modeled).
[hf:meta-llama/Llama-4; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    layer_pattern=("attn_global:dense", "attn_global:moe"),
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25,
                  shared_expert=True, moe_every=2),
)
