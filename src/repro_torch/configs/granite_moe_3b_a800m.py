"""Granite-3.0 MoE [hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from .base import ModelCfg, MoECfg, smoke_variant

CONFIG = ModelCfg(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512, vocab=49155,
    d_head=64, rope_theta=1e4, tie_embeddings=True,
    moe=MoECfg(n_experts=40, top_k=8, d_expert=512),
)
SMOKE_CONFIG = smoke_variant(CONFIG)
