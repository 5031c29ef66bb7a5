"""DeepSeek-Coder 33B [arXiv:2401.14196] — llama-style dense GQA."""
from .base import ModelCfg, smoke_variant

CONFIG = ModelCfg(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv=8, d_ff=19200, vocab=32256,
    d_head=128, rope_theta=1e5,
)
SMOKE_CONFIG = smoke_variant(CONFIG)
