"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; assigned config]."""
from .base import ModelCfg, MoECfg, smoke_variant

CONFIG = ModelCfg(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, d_ff=1536, vocab=151936,
    d_head=128, rope_theta=1e6,
    moe=MoECfg(n_experts=128, top_k=8, d_expert=1536),
)
SMOKE_CONFIG = smoke_variant(CONFIG)
