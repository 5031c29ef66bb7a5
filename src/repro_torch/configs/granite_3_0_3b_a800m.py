"""IBM Granite 3.0 MoE, 3B total, 800M active, as published.

Source: https://huggingface.co/ibm-granite/granite-3.0-3b-a800m-base
/blob/main/config.json (``model_type`` ``granitemoe``, HF
``GraniteMoeForCausalLM``).  The widths are those of
``granite-moe-3b-a800m``, the JAX package's stand-in at granite's widths;
this configuration adds what that one leaves out of the published
equations, on fields of :class:`GraniteCfg` that every other
configuration lacks (the models read neutral values there):

  * the embedding x ``embedding_multiplier`` (12.0);
  * an attention softmax scale of ``attention_multiplier`` (0.015625 =
    1/64, not 1/sqrt(64));
  * each residual branch x ``residual_multiplier`` (0.22);
  * the logits / ``logits_scaling`` (6.0);
  * a dropless expert layer (HF's ``GraniteMoeParallelExperts`` sizes each
    expert by its routed count): top-8 of the router's logits, softmax
    over the 8, and every routed entry computed.

Recalled, not read from a file here (no download): the four multipliers
and ``rms_norm_eps`` 1e-6 (the port's RMSNorm epsilon).  The RMSNorm
weight is the published ``weight * x_hat``; the port stores ``weight - 1``
(its norms are ``(1 + scale) * x_hat``).
"""

from dataclasses import dataclass
from typing import Optional

from .base import ModelCfg, MoECfg, smoke_variant


@dataclass(frozen=True)
class GraniteCfg(ModelCfg):
    """A decoder with Granite's muP multipliers and a dropless MoE.
    ``attention_multiplier`` None is the usual 1/sqrt(head_dim)."""
    embedding_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    dropless: bool = False


CONFIG = GraniteCfg(
    name="granite-3.0-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, d_ff=512, vocab=49155,
    d_head=64, rope_theta=1e4, tie_embeddings=True,
    moe=MoECfg(n_experts=40, top_k=8, d_expert=512),
    embedding_multiplier=12.0, attention_multiplier=0.015625,
    residual_multiplier=0.22, logits_scaling=6.0, dropless=True,
)
SMOKE_CONFIG = smoke_variant(CONFIG)
