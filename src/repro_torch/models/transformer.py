"""Generic decoder LM for the dense and MoE families.

The port of ``repro/models/transformer.py``: one code path parameterised
by :class:`ModelCfg` covers qwen3-moe, granite-moe, deepseek-coder, gemma3
(5:1 local:global windows), qwen1.5 (QKV bias) and command-r (parallel
block, LayerNorm).  The reference stacks its layers under a leading L axis
and scans them; here :class:`DecoderLM` holds an ``nn.ModuleList`` of
blocks, each with the reference's parameter names, and a Python loop runs
them.  The KV cache keeps the reference's layout, a dict of (L, B, T, KV,
Dh) tensors, so caches of the two packages compare directly;
:func:`decode_step` writes it in place.

qwen2-vl's M-RoPE and patch input are ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelCfg
from . import blocks as B
from .moe import apply_moe, moe_params

FAMILIES = ("dense", "moe")


def check_family(cfg: ModelCfg) -> None:
    if cfg.family not in FAMILIES or cfg.pos != "rope":
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}) is not ported yet: ROADMAP "
            "Queue 1 item 2")


# --------------------------------------------------------------- params

def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class Block(nn.Module):
    """One layer's weights under the reference's names: ``ln1``, ``attn``,
    ``ln2`` (not in a parallel block), and ``moe`` or ``mlp``."""

    def __init__(self, cfg: ModelCfg, gen, device):
        super().__init__()
        self.ln1 = _params(B.norm_params(cfg, device))
        self.attn = _params(B.attn_params(cfg, gen, device))
        if not cfg.parallel_block:
            self.ln2 = _params(B.norm_params(cfg, device))
        if cfg.moe is not None:
            self.moe = _params(moe_params(cfg, gen, device))
        else:
            self.mlp = _params(B.mlp_params(cfg, gen, device,
                                            gated=cfg.gated_mlp))


class DecoderLM(nn.Module):
    """The decoder's weights: ``embed`` (padded_vocab, d), ``blocks``,
    ``final_norm`` and, unless the embeddings are tied, ``head`` (d,
    padded_vocab); buffers for the vocab mask and the RoPE frequencies.
    Draws the weights from ``generator`` with the reference's
    distributions (not its numbers: torch cannot replay jax's streams), or
    leaves them uninitialised for :mod:`.convert` when it is None."""

    def __init__(self, cfg: ModelCfg, *, device="cuda", generator=None):
        super().__init__()
        check_family(cfg)
        dev = resolve_device(device)
        dt = B.dtype_of(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(
            B.normal((cfg.padded_vocab, cfg.d_model), 0.02, dt, generator,
                     dev), requires_grad=False)
        self.blocks = nn.ModuleList(Block(cfg, generator, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _params(B.norm_params(cfg, dev))
        if not cfg.tie_embeddings:
            self.head = nn.Parameter(
                B.dense_init(generator, cfg.d_model, cfg.padded_vocab, dt,
                             dev), requires_grad=False)
        self.register_buffer("vocab_mask", B.vocab_mask(cfg, dt, dev),
                             persistent=False)
        self.register_buffer("rope_freqs", torch.as_tensor(
            B.rope_freqs(cfg.head_dim, cfg.rope_theta), dtype=torch.float32,
            device=dev), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def logits(self, x):
        """Final norm, head (the embedding's transpose when tied) and the
        vocab padding mask."""
        x = B.apply_norm(self.cfg, self.final_norm, x)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return x @ head + self.vocab_mask


def layer_windows(cfg: ModelCfg) -> np.ndarray:
    """Per-layer attention window (0 = full/global attention)."""
    w = np.zeros(cfg.n_layers, np.int32)
    if cfg.window:
        w[:] = cfg.window
        if cfg.window_pattern:   # every Nth layer global (gemma3: 6th)
            w[cfg.window_pattern - 1::cfg.window_pattern] = 0
    return w


# --------------------------------------------------------------- forward

def embed_inputs(cfg: ModelCfg, model: DecoderLM, batch):
    """tokens (B, S) -> (B, S, d) activations and (B, S) positions."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    x = model.embed[tokens].to(B.dtype_of(cfg))
    b, s = tokens.shape
    positions = torch.arange(s, device=model.device).expand(b, s)
    return x, positions


def _layer(cfg: ModelCfg, blk: Block, x, positions, rope, window: int,
           need_aux: bool):
    """One block over a whole sequence -> (x, (k, v), aux or None)."""
    h = B.apply_norm(cfg, blk.ln1, x)
    q, k, v = B._qkv(cfg, blk.attn, h, positions, rope)
    attn = B.attend(q, k, v, window, cfg)
    attn = attn.reshape(x.shape[0], x.shape[1], -1) @ blk.attn["wo"]
    aux = None
    if cfg.parallel_block:
        x = x + attn + B.apply_mlp(cfg, blk.mlp, h)
    else:
        x = x + attn
        h2 = B.apply_norm(cfg, blk.ln2, x)
        if cfg.moe is not None:
            y, aux = apply_moe(cfg, blk.moe, h2, need_aux=need_aux)
        else:
            y = B.apply_mlp(cfg, blk.mlp, h2)
        x = x + y
    return x, (k, v), aux


def forward(cfg: ModelCfg, model: DecoderLM, batch):
    """Full-sequence forward.  Returns (logits (B, S, V), aux)."""
    x, positions = embed_inputs(cfg, model, batch)
    rope = B.rope_tables(positions, model.rope_freqs)
    aux = torch.zeros((), dtype=torch.float32, device=model.device)
    for blk, w in zip(model.blocks, layer_windows(cfg)):
        x, _, a = _layer(cfg, blk, x, positions, rope, int(w), True)
        if a is not None:
            aux = aux + a
    return model.logits(x), aux / cfg.n_layers


# --------------------------------------------------------------- decode

def init_cache(cfg: ModelCfg, batch, max_len, device="cuda"):
    dt = B.dtype_of(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def prefill(cfg: ModelCfg, model: DecoderLM, batch):
    """Forward over the prompt -> (last logits (B, 1, V), cache of S
    slots)."""
    x, positions = embed_inputs(cfg, model, batch)
    rope = B.rope_tables(positions, model.rope_freqs)
    ks, vs = [], []
    for blk, w in zip(model.blocks, layer_windows(cfg)):
        x, (k, v), _ = _layer(cfg, blk, x, positions, rope, int(w), False)
        ks.append(k)
        vs.append(v)
    return model.logits(x[:, -1:]), {"k": torch.stack(ks),
                                     "v": torch.stack(vs)}


def decode_step(cfg: ModelCfg, model: DecoderLM, token, cache,
                cache_len: int):
    """One-token decode.  token: (B, 1).  Writes slot ``cache_len`` of
    every layer's cache in place; returns (logits (B, 1, V), cache)."""
    cache_len = int(cache_len)
    token = torch.as_tensor(token, device=model.device)
    x = model.embed[token].to(B.dtype_of(cfg))
    positions = torch.full(token.shape, cache_len, dtype=torch.int32,
                           device=model.device)
    rope = B.rope_tables(positions, model.rope_freqs)
    quant = "k_scale" in cache
    t = cache["k"].shape[2]
    for i, (blk, w) in enumerate(zip(model.blocks, layer_windows(cfg))):
        h = B.apply_norm(cfg, blk.ln1, x)
        win = int(w) if w > 0 else t + 1
        if quant:
            out = B.decode_attention_quant(
                cfg, blk.attn, h, positions, cache["k"][i], cache["v"][i],
                cache["k_scale"][i], cache["v_scale"][i], cache_len,
                window=win, rope=rope)[0]
        else:
            out = B.decode_attention(cfg, blk.attn, h, positions,
                                     cache["k"][i], cache["v"][i], cache_len,
                                     window=win, rope=rope)[0]
        if cfg.parallel_block:
            x = x + out + B.apply_mlp(cfg, blk.mlp, h)
        else:
            x = x + out
            h2 = B.apply_norm(cfg, blk.ln2, x)
            y = (apply_moe(cfg, blk.moe, h2, need_aux=False)[0]
                 if cfg.moe is not None else B.apply_mlp(cfg, blk.mlp, h2))
            x = x + y
    return model.logits(x), cache
