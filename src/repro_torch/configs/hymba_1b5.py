"""Hymba 1.5B [arXiv:2411.13676] — parallel attention + Mamba heads."""
from .base import ModelCfg, SSMCfg, smoke_variant

CONFIG = ModelCfg(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv=5, d_ff=5504, vocab=32001,
    d_head=64, window=1024, ssm=SSMCfg(state_dim=16, d_conv=4, expand=2),
)
SMOKE_CONFIG = smoke_variant(CONFIG, n_heads=4, n_kv=2)
