"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dep decay."""
from .base import ModelCfg, smoke_variant

CONFIG = ModelCfg(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv=32, d_ff=7168, vocab=65536,
    d_head=64,
)
SMOKE_CONFIG = smoke_variant(CONFIG)
