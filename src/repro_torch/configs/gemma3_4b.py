"""Gemma-3 4B [hf:google/gemma-3 family] — 5:1 local:global, 128k ctx."""
from .base import ModelCfg, smoke_variant

CONFIG = ModelCfg(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv=4, d_ff=10240, vocab=262144,
    d_head=256, act="gelu", tie_embeddings=True, rope_theta=1e6,
    window=1024, window_pattern=6,     # every 6th layer global
)
SMOKE_CONFIG = smoke_variant(CONFIG)
