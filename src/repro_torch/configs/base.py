"""Architecture config schema + input-shape cells (assigned pool).

Every assigned architecture exports ``CONFIG`` (exact published numbers) and
``SMOKE_CONFIG`` (reduced same-family config for CPU smoke tests).  Shape
cells are global: train_4k / prefill_32k / decode_32k / long_500k.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden
    capacity_factor: float = 1.25
    router_use_radix: bool = True  # route top-k through the paper's engine


@dataclass(frozen=True)
class SSMCfg:
    state_dim: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attn-free)
    n_kv: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    parallel_block: bool = False  # command-r style (attn + mlp in parallel)
    norm: str = "rms"             # rms | ln
    act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)
    gated_mlp: bool = True        # False -> plain 2-layer MLP (whisper)
    pos: str = "rope"             # rope | abs (sinusoidal additive)
    rope_theta: float = 1e6
    mrope_sections: Optional[tuple] = None   # qwen2-vl (t, h, w) dims
    window: Optional[int] = None              # sliding-window size
    window_pattern: int = 0       # every Nth layer is global (0 = all global)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    n_enc_layers: int = 0         # whisper encoder depth
    enc_ctx: int = 0              # precomputed frame/patch positions (stub)
    vision_patches: int = 0       # vlm stub patch count
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        if self.d_head is not None:
            return self.d_head
        return self.d_model // max(1, self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to a multiple of 256 so embedding/head shard over
        any TP degree up to 256 (standard Megatron/MaxText practice).  Extra
        rows are masked to -inf at the logits."""
        return -(-self.vocab // 256) * 256

    def param_count(self) -> int:
        """Total parameters (embedding + blocks), for roofline MODEL_FLOPS."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = 0
        if self.n_heads:
            qd = self.n_heads * self.head_dim
            kvd = self.n_kv * self.head_dim
            attn = d * qd + 2 * d * kvd + qd * d
        if self.moe is not None:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_expert + d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        if self.family == "ssm":       # rwkv6: token-mix replaces attention
            attn = 6 * d * d           # r,k,v,g,o + decay projections (approx)
            ffn = 2 * d * self.d_ff + d * d
        if self.family == "hybrid" and self.ssm is not None:
            attn += 2 * d * d * self.ssm.expand  # mamba in/out projections
        enc = self.n_enc_layers * (4 * d * d + 3 * d * self.d_ff)
        cross = (4 * d * d) * L if self.family == "encdec" else 0
        return emb + L * (attn + ffn) + enc + cross

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        dense = self.param_count() - L * self.moe.n_experts * 3 * d * self.moe.d_expert
        return dense + L * self.moe.top_k * 3 * d * self.moe.d_expert


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k requires a sub-quadratic context mechanism (SSM state, sliding
# window, or hybrid); pure full-attention archs skip it (DESIGN.md §6).
LONG_CTX_OK = {"rwkv6-1.6b", "hymba-1.5b", "gemma3-4b"}


def smoke_variant(cfg: ModelCfg, **overrides) -> ModelCfg:
    """Reduced same-family config: tiny dims, same structural features."""
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=8, top_k=2, d_expert=64)
    base = dict(
        n_layers=2, d_model=64, n_heads=4 if cfg.n_heads else 0,
        n_kv=2 if cfg.n_kv else 0, d_ff=128, vocab=256, d_head=16,
        moe=moe, n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_ctx=16 if cfg.enc_ctx else 0,
        vision_patches=8 if cfg.vision_patches else 0,
        window=min(cfg.window, 32) if cfg.window else None,
        dtype="float32",
    )
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
