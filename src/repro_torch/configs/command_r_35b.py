"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01] — parallel block, LN,
no biases, tied embeddings."""
from .base import ModelCfg, smoke_variant

CONFIG = ModelCfg(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv=8, d_ff=22528, vocab=256000,
    d_head=128, parallel_block=True, norm="ln", tie_embeddings=True,
    rope_theta=1e4,
)
SMOKE_CONFIG = smoke_variant(CONFIG)
