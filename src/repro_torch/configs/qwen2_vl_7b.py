"""Qwen2-VL 7B [arXiv:2409.12191] — M-RoPE; vision frontend stubbed to
precomputed patch embeddings."""
from .base import ModelCfg, smoke_variant

CONFIG = ModelCfg(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv=4, d_ff=18944, vocab=152064,
    d_head=128, qkv_bias=True, rope_theta=1e6,
    mrope_sections=(16, 24, 24),    # t/h/w channels, sum = head_dim/2
    vision_patches=256,
)
SMOKE_CONFIG = smoke_variant(CONFIG, mrope_sections=(2, 3, 3))
