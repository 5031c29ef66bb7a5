"""Whisper backbone: an encoder-decoder transformer.

The port of ``repro/models/whisper.py``.  The conv/mel frontend is a stub
as there: the encoder takes precomputed frame embeddings (B, enc_ctx,
d_model).  Encoder: bidirectional self-attention; decoder: causal
self-attention and cross-attention to the encoder's output.  LayerNorm, a
plain (not gated) GELU MLP, sinusoidal absolute positions, no RoPE; the
output head is the embedding's transpose.

The decode cache keeps the reference's layout: a self-attention cache
``k`` / ``v`` (L, B, T, KV, Dh), written in place by :func:`decode_step`,
and the cross-attention ``xk`` / ``xv`` (L, B, enc_ctx, KV, Dh), computed
once from the encoder by :func:`init_cache`.  On CUDA tensors attention
runs through ``F.scaled_dot_product_attention`` (:func:`blocks.sdpa_fused`:
the encoder and the cross-attention unmasked, a decode step over the
cache's valid slice); on the CPU through the reference's plain sdpa.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelCfg
from . import blocks as B
from .transformer import LM, _params


class EncLayer(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp`` (up, down)."""

    def __init__(self, cfg: ModelCfg, gen, device):
        super().__init__()
        self.ln1 = _params(B.norm_params(cfg, device))
        self.attn = _params(B.attn_params(cfg, gen, device))
        self.ln2 = _params(B.norm_params(cfg, device))
        self.mlp = _params(B.mlp_params(cfg, gen, device, gated=False))


class DecLayer(EncLayer):
    """An encoder layer's weights plus ``lnx`` and ``xattn``, the
    cross-attention."""

    def __init__(self, cfg: ModelCfg, gen, device):
        super().__init__(cfg, gen, device)
        self.lnx = _params(B.norm_params(cfg, device))
        self.xattn = _params(B.attn_params(cfg, gen, device))


class WhisperModel(LM):
    """The weights: ``embed``, ``enc_blocks``, ``dec_blocks``, ``enc_norm``
    and ``final_norm`` (the reference's ``enc_layers`` / ``dec_layers``
    hold the blocks); the vocab mask as a buffer.  Drawn from
    ``generator``, or left uninitialised for :mod:`.convert`."""

    def __init__(self, cfg: ModelCfg, *, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(
            B.normal((cfg.padded_vocab, cfg.d_model), 0.02, B.dtype_of(cfg),
                     generator, dev), requires_grad=False)
        self.enc_blocks = nn.ModuleList(EncLayer(cfg, generator, dev)
                                        for _ in range(cfg.n_enc_layers))
        self.dec_blocks = nn.ModuleList(DecLayer(cfg, generator, dev)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = _params(B.norm_params(cfg, dev))
        self.final_norm = _params(B.norm_params(cfg, dev))
        self.register_buffer("vocab_mask",
                             B.vocab_mask(cfg, B.dtype_of(cfg), dev),
                             persistent=False)


def _heads(cfg: ModelCfg, t, n):
    return t.reshape(t.shape[0], t.shape[1], n, cfg.head_dim)


def _attention(cfg: ModelCfg, q, k, v):
    """Unmasked attention (the encoder's, the cross-attention)."""
    if B.fused_path(q):
        return B.sdpa_fused(q, k, v)
    return B.sdpa(q, k, v, None, cfg)


def _attn_full(cfg: ModelCfg, p, x, kv_src):
    b, s, _ = x.shape
    q = _heads(cfg, x @ p["wq"], cfg.n_heads)
    k = _heads(cfg, kv_src @ p["wk"], cfg.n_kv)
    v = _heads(cfg, kv_src @ p["wv"], cfg.n_kv)
    return _attention(cfg, q, k, v).reshape(b, s, -1) @ p["wo"]


def _self_attn_causal(cfg: ModelCfg, p, x):
    """Decoder self-attention over a whole sequence (no RoPE)."""
    b, s, _ = x.shape
    q = _heads(cfg, x @ p["wq"], cfg.n_heads)
    k = _heads(cfg, x @ p["wk"], cfg.n_kv)
    v = _heads(cfg, x @ p["wv"], cfg.n_kv)
    return B.attend(q, k, v, 0, cfg).reshape(b, s, -1) @ p["wo"]


def _enc_layer(cfg: ModelCfg, lp: EncLayer, x):
    h = B.apply_norm(cfg, lp.ln1, x)
    x = x + _attn_full(cfg, lp.attn, h, h)
    return x + B.apply_mlp(cfg, lp.mlp, B.apply_norm(cfg, lp.ln2, x))


def _dec_layer(cfg: ModelCfg, lp: DecLayer, x, enc_out):
    x = x + _self_attn_causal(cfg, lp.attn, B.apply_norm(cfg, lp.ln1, x))
    x = x + _attn_full(cfg, lp.xattn, B.apply_norm(cfg, lp.lnx, x), enc_out)
    return x + B.apply_mlp(cfg, lp.mlp, B.apply_norm(cfg, lp.ln2, x))


def encode(cfg: ModelCfg, model: WhisperModel, frames):
    """frames: (B, enc_ctx, d_model) precomputed embeddings -> the
    encoder's normed output.  Under autograd each layer's activations are
    recomputed in backward, as the reference's encoder always does."""
    dt = B.dtype_of(cfg)
    frames = torch.as_tensor(frames, device=model.device)
    x = frames.to(dt) + B.sincos(frames.shape[1], cfg.d_model, dt,
                                 model.device)
    for lp in model.enc_blocks:
        x = B.layer_call(_enc_layer, cfg, lp, x)
    return B.apply_norm(cfg, model.enc_norm, x)


def forward(cfg: ModelCfg, model: WhisperModel, batch, *, remat=True):
    """Frames and decoder tokens -> (logits (B, S, V), aux 0).  The
    logits carry no vocab mask, as the reference's do.  ``remat``: each
    decoder layer's activations are recomputed in backward."""
    enc_out = encode(cfg, model, batch["frames"])
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    x = F.embedding(tokens, model.embed).to(B.dtype_of(cfg))
    x = x + B.sincos(tokens.shape[1], cfg.d_model, x.dtype, model.device)
    for lp in model.dec_blocks:
        x = B.layer_call(_dec_layer, cfg, lp, x, enc_out, remat=remat)
    x = B.apply_norm(cfg, model.final_norm, x)
    return x @ model.embed.T, torch.zeros((), dtype=torch.float32,
                                          device=model.device)


def init_cache(cfg: ModelCfg, model: WhisperModel, frames, max_len):
    """Decode cache: an empty self-attention cache of ``max_len`` slots and
    the cross-attention K/V of every layer, from the encoder."""
    enc_out = encode(cfg, model, frames)
    b = enc_out.shape[0]
    dt = B.dtype_of(cfg)
    xk = torch.stack([_heads(cfg, enc_out @ lp.xattn["wk"], cfg.n_kv)
                      for lp in model.dec_blocks])
    xv = torch.stack([_heads(cfg, enc_out @ lp.xattn["wv"], cfg.n_kv)
                      for lp in model.dec_blocks])
    shape = (cfg.n_layers, b, max_len, cfg.n_kv, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=model.device),
            "v": torch.zeros(shape, dtype=dt, device=model.device),
            "xk": xk, "xv": xv}


def decode_step(cfg: ModelCfg, model: WhisperModel, token, cache,
                cache_len: int):
    """One-token decode.  token: (B, 1).  Writes slot ``cache_len`` of the
    self-attention cache in place; returns (logits (B, 1, V), cache)."""
    cache_len = int(cache_len)
    dev = model.device
    token = torch.as_tensor(token, device=dev)
    b = token.shape[0]
    x = model.embed[token].to(B.dtype_of(cfg))
    x = x + B.sincos_at(cache_len, cfg.d_model, x.dtype, dev)
    for i, lp in enumerate(model.dec_blocks):
        h = B.apply_norm(cfg, lp.ln1, x)
        # self-attention against the cache (no RoPE: absolute positions)
        q = _heads(cfg, h @ lp.attn["wq"], cfg.n_heads)
        ck, cv = cache["k"][i], cache["v"][i]
        ck[:, cache_len] = (h @ lp.attn["wk"]).reshape(
            b, cfg.n_kv, cfg.head_dim).to(ck.dtype)
        cv[:, cache_len] = (h @ lp.attn["wv"]).reshape(
            b, cfg.n_kv, cfg.head_dim).to(cv.dtype)
        out = B._attend_cache(cfg, q, ck, cv, cache_len, None)
        x = x + out.reshape(b, 1, -1) @ lp.attn["wo"]
        hx = B.apply_norm(cfg, lp.lnx, x)
        qx = _heads(cfg, hx @ lp.xattn["wq"], cfg.n_heads)
        outx = _attention(cfg, qx, cache["xk"][i], cache["xv"][i])
        x = x + outx.reshape(b, 1, -1) @ lp.xattn["wo"]
        x = x + B.apply_mlp(cfg, lp.mlp, B.apply_norm(cfg, lp.ln2, x))
    return model.logits(x), cache
