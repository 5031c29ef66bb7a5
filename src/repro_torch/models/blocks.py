"""Shared model-building blocks: plain functions on tensors.

The port of ``repro/models/blocks.py``.  Conventions as there: activations flow as (batch, seq, d_model) in
``cfg.dtype``; weights keep the reference's ``(in, out)`` layout, so a
projection is ``x @ w``; a layer's cache is (B, T, KV, Dh).  The functions
that make parameters take a ``torch.Generator`` (``None`` leaves the
tensors uninitialised, for a loader to fill) and the device to build on.

Attention has two versions.  For CPU tensors, :func:`sdpa` is the
reference's arithmetic: an einsum, a float32 softmax, masked scores at
-1e30.  For CUDA tensors, ``F.scaled_dot_product_attention`` computes the
same function (the reference leaves attention to XLA, outside any Pallas
kernel, so no hand-written kernel is due).  On the card a decode step
attends over the cache's valid slice instead of masking the rest: the
masked scores weigh exactly 0 in the reference, so the sum is the same.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelCfg

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ---------------------------------------------------------------- helpers


def dtype_of(cfg: ModelCfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def multiplier(cfg: ModelCfg, name: str) -> float:
    """One of granite's muP multipliers (``embedding_multiplier``,
    ``residual_multiplier``, ``logits_scaling``: fields of
    :class:`~repro_torch.configs.granite_3_0_3b_a800m.GraniteCfg`); 1.0,
    which the callers skip, on a configuration without them."""
    return getattr(cfg, name, 1.0)


def attn_scale(cfg: ModelCfg):
    """The softmax scale of the scores: the configuration's
    ``attention_multiplier`` where it has one (granite's 1/64), else None,
    the usual 1/sqrt(head_dim)."""
    return getattr(cfg, "attention_multiplier", None)


def normal(shape, scale, dtype, gen, device) -> torch.Tensor:
    """Standard normal draws in float32 times ``scale``, cast to ``dtype``
    (the reference's initialiser); uninitialised when ``gen`` is None."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def dense_init(gen, in_dim, out_dim, dtype, device):
    return normal((in_dim, out_dim), 1.0 / np.sqrt(in_dim), dtype, gen,
                  device)


def layer_call(fn, *args, remat: bool = True):
    """``fn(*args)``, its activations recomputed in backward (the
    reference's per-layer ``jax.checkpoint``) when ``remat`` is set and
    autograd records; a serving call under ``no_grad`` runs it plainly."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def vocab_mask(cfg: ModelCfg, dtype=None, device="cpu") -> torch.Tensor:
    """(padded_vocab,) additive mask: 0 on real ids, -1e30 on padding rows."""
    ids = torch.arange(cfg.padded_vocab, device=device)
    m = torch.where(ids < cfg.vocab, 0.0, -1e30)
    return m.to(dtype or torch.float32)


# ---------------------------------------------------------------- norms

def rms_norm(x, scale, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm_params(cfg: ModelCfg, device) -> dict:
    d = cfg.d_model
    dt = dtype_of(cfg)
    if cfg.norm == "rms":
        return {"scale": torch.zeros((d,), dtype=dt, device=device)}
    return {"scale": torch.ones((d,), dtype=dt, device=device),
            "bias": torch.zeros((d,), dtype=dt, device=device)}


def apply_norm(cfg: ModelCfg, p, x):
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------- RoPE

def rope_freqs(head_dim, theta):
    """Float64 in numpy, as the reference computes them; callers cast."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def rope_tables(positions, freqs):
    """(cos, sin), each (B, S, 1, Dh/2) float32, for ``positions`` (B, S)
    and :func:`rope_freqs` as a float32 tensor on their device: computed
    once a forward and shared by every layer."""
    ang = positions[..., None].float() * freqs
    return ang.cos()[..., None, :], ang.sin()[..., None, :]


def mrope_tables(positions3, freqs, sections):
    """:func:`rope_tables` for Qwen2-VL's multimodal RoPE: ``positions3``
    (B, S, 3) holds the (t, h, w) ids, and frequency channel j rotates by
    the stream of its section (``sections`` sums to Dh/2)."""
    sec_id = np.concatenate([np.full(s, i) for i, s in enumerate(sections)])
    if sec_id.shape[0] != freqs.shape[0]:
        raise ValueError(f"mrope sections {sections} must sum to Dh/2 = "
                         f"{freqs.shape[0]}")
    idx = torch.as_tensor(sec_id, dtype=torch.int64,
                          device=positions3.device)
    ang = positions3.float()[..., idx] * freqs              # (B, S, Dh/2)
    return ang.cos()[..., None, :], ang.sin()[..., None, :]


def _rotate(x, tables):
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _freqs(x, theta):
    return torch.as_tensor(rope_freqs(x.shape[-1], theta),
                           dtype=torch.float32, device=x.device)


def apply_rope(x, positions, theta, tables=None):
    """x: (B, S, H, Dh); positions: (B, S).  Half-split rotation."""
    if tables is None:
        tables = rope_tables(positions, _freqs(x, theta))
    return _rotate(x, tables)


def apply_mrope(x, positions3, theta, sections, tables=None):
    """x: (B, S, H, Dh); positions3: (B, S, 3) (t, h, w) ids, each section
    of the frequency channels rotated by its own stream."""
    if tables is None:
        tables = mrope_tables(positions3, _freqs(x, theta), sections)
    return _rotate(x, tables)


# ---------------------------------------------------------------- sinusoid

def sincos(s, d, dtype, device):
    """(1, s, d) absolute sinusoid of positions 0..s-1: computed in numpy
    float64 and cast to float32 then ``dtype``, as the reference's
    ``_sincos`` is."""
    pos = np.arange(s)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    table = np.concatenate([np.sin(ang), np.cos(ang)], -1)[None]
    return torch.as_tensor(table, dtype=torch.float32,
                           device=device).to(dtype)


def sincos_at(pos: int, d, dtype, device):
    """(1, 1, d) sinusoid of one decode position, computed in float32 as
    the reference's decode steps compute it (not :func:`sincos`)."""
    i = torch.arange(d // 2, device=device)
    ang = pos / (10000 ** (2 * i / d))
    return torch.cat([ang.sin(), ang.cos()])[None, None].to(dtype)


# ---------------------------------------------------------------- attention

def attn_params(cfg: ModelCfg, gen, device) -> dict:
    dt = dtype_of(cfg)
    qd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv * cfg.head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, qd, dt, device),
        "wk": dense_init(gen, cfg.d_model, kvd, dt, device),
        "wv": dense_init(gen, cfg.d_model, kvd, dt, device),
        "wo": dense_init(gen, qd, cfg.d_model, dt, device),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", qd), ("bk", kvd), ("bv", kvd)):
            p[name] = torch.zeros((n,), dtype=dt, device=device)
    return p


def _qkv(cfg: ModelCfg, p, x, positions, rope=None):
    """Projections, heads and RoPE (M-RoPE over ``positions`` (B, S, 3)
    where the config has sections); ``rope`` is the tables of
    ``positions`` (:func:`rope_tables`, :func:`mrope_tables`) where the
    caller has them."""
    b, s, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv, cfg.head_dim)
    if cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections,
                        rope)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections,
                        rope)
    else:
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


def sdpa(q, k, v, mask, cfg: ModelCfg):
    """(B,S,H,Dh) x (B,T,KV,Dh) grouped attention; fp32 softmax.  Query
    head h reads KV head h // (H / KV)."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    q = q.reshape(b, s, kv, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", q, k).float()
    scale = attn_scale(cfg)
    scores = scores / np.sqrt(dh) if scale is None else scores * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


# cuDNN's attention is left out: on an H100 (torch 2.11, CUDA 12.8) it
# made gemma3-4b's decode differ from run to run on the same inputs
# (scripts/sdpa_repeat.py), and a serving run must repeat under the same
# generator.  Flash attention takes
# the causal prefill and the decode; a windowed prefill (a mask, GQA) runs
# on the math backend.
_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.MATH]

# The attention cost model of ``launch/analytic.py``: on the card a causal
# attention is one flash kernel at every length (no switch by length, as
# the reference's blockwise scan has from 2048 on), modelled as streaming
# K/V once a query tile of 128 rows.  The reference's constants are 512
# and 2048.
FLASH_BLOCK = 128
FLASH_MIN_SEQ = 1


def fused_path(t: torch.Tensor) -> bool:
    """Whether attention on ``t`` takes :func:`sdpa_fused`: on the card,
    and on ``meta``, where the dry-run traces the card's step."""
    return t.device.type in ("cuda", "meta")


def _flash_shapes(q, k, v, causal):
    """The flash kernel's op on ``meta`` (shapes only: the dry-run), whose
    cost the FLOP counter knows; ``F.scaled_dot_product_attention``
    lowers to its math backend there."""
    h, kv = q.shape[2], k.shape[2]
    if h != kv:       # GQA: the op takes H heads; meta has no values to copy
        k = k.new_empty(k.shape[:2] + (h,) + k.shape[3:])
        v = v.new_empty(v.shape[:2] + (h,) + v.shape[3:])
    return torch.ops.aten._scaled_dot_product_flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 0.0,
        causal)[0].transpose(1, 2)


def sdpa_fused(q, k, v, mask=None, causal=False, scale=None):
    """:func:`sdpa` through ``F.scaled_dot_product_attention`` (CUDA
    tensors): ``mask`` (S, T) bool, True where a key is seen; ``scale``
    the scores' (None: 1/sqrt(Dh)).  GQA maps query head h on KV head h //
    (H / KV), as :func:`sdpa` does.  On ``meta`` an unmasked call is the
    flash kernel's op."""
    if q.device.type == "meta" and mask is None:
        return _flash_shapes(q, k, v, causal)
    with sdpa_kernel(_BACKENDS):
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal, scale=scale,
            enable_gqa=q.shape[2] != k.shape[2])
    return out.transpose(1, 2)


def causal_mask(s, t, window=None, device="cpu"):
    """(1,1,1,s,t) mask; window=None -> plain causal."""
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None, None, None]


def attend(q, k, v, window: int, cfg: ModelCfg):
    """Causal self-attention over a whole sequence, ``window`` > 0 keys
    back (0 = full causal).  The reference's blockwise path for long
    sequences (``sdpa_blockwise``, a memory device of XLA's) computes the
    same function as the direct one, so the plain version is the direct
    :func:`sdpa` at every length."""
    s = q.shape[1]
    windowed = 0 < window < s
    if fused_path(q):
        scale = attn_scale(cfg)
        if not windowed:
            return sdpa_fused(q, k, v, causal=True, scale=scale)
        return sdpa_fused(q, k, v, causal_mask(s, s, window,
                                               device=q.device)[0, 0, 0],
                          scale=scale)
    mask = causal_mask(s, s, window if windowed else None, device=q.device)
    return sdpa(q, k, v, mask, cfg)


def _attend_cache(cfg, q, cache_k, cache_v, cache_len, window):
    """One query against cache slots [0, cache_len], window-clipped."""
    lo = 0 if window is None else max(0, cache_len - window + 1)
    if fused_path(q):
        return sdpa_fused(q, cache_k[:, lo:cache_len + 1],
                          cache_v[:, lo:cache_len + 1],
                          scale=attn_scale(cfg))
    kpos = torch.arange(cache_k.shape[1], device=q.device)
    valid = (kpos <= cache_len) & (kpos >= lo)
    return sdpa(q, cache_k, cache_v, valid[None, None, None, None, :], cfg)


def decode_attention(cfg: ModelCfg, p, x, positions, cache_k, cache_v,
                     cache_len: int, window=None, rope=None):
    """One-token decode against a (B, T, KV, Dh) cache.

    Writes the new K/V at slot ``cache_len`` **in place** (the reference
    returns updated copies; the port saves the copy) and attends over slots
    [0, cache_len] (window-clipped).  Returns (out, cache_k, cache_v)."""
    q, k, v = _qkv(cfg, p, x, positions, rope)      # s == 1
    cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)
    out = _attend_cache(cfg, q, cache_k, cache_v, cache_len, window)
    b = x.shape[0]
    return out.reshape(b, 1, -1) @ p["wo"], cache_k, cache_v


def decode_attention_quant(cfg: ModelCfg, p, x, positions, cache_k, cache_v,
                           k_scale, v_scale, cache_len: int, window=None,
                           rope=None):
    """:func:`decode_attention` over an int8 cache with per-(slot, head)
    fp32 scales (the kv8 serving variant): new K/V are absmax-quantised on
    write (in place), the cache is dequantised on read."""
    q, k, v = _qkv(cfg, p, x, positions, rope)      # s == 1

    def quantize(t):
        t32 = t[:, 0].float()
        scale = (t32.abs().amax(-1) / 127.0).clamp_min(1e-8)
        q8 = torch.round(t32 / scale[..., None]).clamp(-127, 127)
        return q8.to(torch.int8), scale

    for cache, scales, t in ((cache_k, k_scale, k), (cache_v, v_scale, v)):
        cache[:, cache_len], scales[:, cache_len] = quantize(t)

    def deq(c8, sc):
        return c8.to(x.dtype) * sc.to(x.dtype)[..., None]

    out = _attend_cache(cfg, q, deq(cache_k, k_scale), deq(cache_v, v_scale),
                        cache_len, window)
    b = x.shape[0]
    return (out.reshape(b, 1, -1) @ p["wo"], cache_k, cache_v,
            k_scale, v_scale)


# ---------------------------------------------------------------- MLP

def mlp_params(cfg: ModelCfg, gen, device, gated=True) -> dict:
    dt = dtype_of(cfg)
    d_ff = cfg.d_ff
    p = {"up": dense_init(gen, cfg.d_model, d_ff, dt, device),
         "down": dense_init(gen, d_ff, cfg.d_model, dt, device)}
    if gated:
        p["gate"] = dense_init(gen, cfg.d_model, d_ff, dt, device)
    return p


def activation(cfg: ModelCfg):
    """SwiGLU's SiLU, or GeGLU's GELU in the tanh form that
    ``jax.nn.gelu`` takes by default."""
    if cfg.act == "silu":
        return F.silu
    return functools.partial(F.gelu, approximate="tanh")


def apply_mlp(cfg: ModelCfg, p, x):
    act = activation(cfg)
    if "gate" in p:
        return (act(x @ p["gate"]) * (x @ p["up"])) @ p["down"]
    return act(x @ p["up"]) @ p["down"]
