"""Qwen1.5 32B [hf:Qwen/Qwen1.5 family] — MHA with QKV bias."""
from .base import ModelCfg, smoke_variant

CONFIG = ModelCfg(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=40, d_ff=27392, vocab=152064,
    d_head=128, qkv_bias=True, rope_theta=1e6,
)
SMOKE_CONFIG = smoke_variant(CONFIG)
