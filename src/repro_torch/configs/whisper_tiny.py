"""Whisper-tiny [arXiv:2212.04356] — enc-dec; conv/mel frontend stubbed."""
from .base import ModelCfg, smoke_variant

CONFIG = ModelCfg(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv=6, d_ff=1536, vocab=51865,
    d_head=64, norm="ln", act="gelu", gated_mlp=False, pos="abs",
    n_enc_layers=4, enc_ctx=1500, tie_embeddings=True,
)
SMOKE_CONFIG = smoke_variant(CONFIG)
