"""seamless-m4t-large-v2 [audio] — enc-dec, 24L+24L d1024 16H ff8192
vocab=256206.  Speech frontend (w2v-BERT frames) is a STUB per the
assignment; ``input_specs`` provides precomputed frame embeddings.
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256206,
    enc_dec=True, n_enc_layers=24,
    audio_frames=1024, frontend_dim=1024,
)
