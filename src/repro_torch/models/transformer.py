"""Generic decoder LM covering the dense, MoE, windowed and M-RoPE
families.

The port of ``repro/models/transformer.py``: one code path parameterised
by :class:`ModelCfg` covers qwen3-moe, granite-moe, deepseek-coder, gemma3
(5:1 local:global windows), qwen1.5 (QKV bias), command-r (parallel
block, LayerNorm) and qwen2-vl (M-RoPE, patch embeddings prepended).  The
reference stacks its layers under a leading L axis and scans them; here
:class:`DecoderLM` holds an ``nn.ModuleList`` of blocks, each with the
reference's parameter names, and a Python loop runs them.  The KV cache
keeps the reference's layout, a dict of (L, B, T, KV, Dh) tensors, so
caches of the two packages compare directly; :func:`decode_step` writes
it in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelCfg
from . import blocks as B
from .moe import apply_moe, moe_params

FAMILIES = ("dense", "moe", "vlm")


def check_family(cfg: ModelCfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(
            f"{cfg.name} (family {cfg.family!r}) is not a decoder LM: "
            "models.api serves it through its family's module")


# --------------------------------------------------------------- params

def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in tensors.items()})


class LM(nn.Module):
    """What every family's model shares: its device, and the logits of the
    final hidden states (final norm, then the head, or the embedding's
    transpose when tied, then the vocab padding mask).  Subclasses hold
    ``embed``, ``final_norm``, ``head`` unless tied, and the
    ``vocab_mask`` buffer."""

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def trainable(self, on: bool = True) -> "LM":
        """Let autograd record every parameter (``on``) or none.  Models
        are built frozen, for serving; training turns every leaf on, as the
        reference differentiates its whole tree (norms, gates and the
        float32 constants of Hymba and RWKV-6 included)."""
        for p in self.parameters():
            p.requires_grad_(on)
        return self

    def logits(self, x):
        x = B.apply_norm(self.cfg, self.final_norm, x)
        head = self.embed.T if self.cfg.tie_embeddings else self.head
        return x @ head + self.vocab_mask


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


class DecoderLM(LM):
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
        if cfg.vision_patches:
            self.patch_proj = nn.Parameter(
                B.dense_init(generator, cfg.d_model, cfg.d_model, dt, dev),
                requires_grad=False)
        self.register_buffer("vocab_mask", B.vocab_mask(cfg, dt, dev),
                             persistent=False)
        self.register_buffer("rope_freqs", torch.as_tensor(
            B.rope_freqs(cfg.head_dim, cfg.rope_theta), dtype=torch.float32,
            device=dev), persistent=False)

    def rope(self, positions):
        """The RoPE (or M-RoPE) tables of ``positions``, shared by every
        layer."""
        if self.cfg.mrope_sections is not None:
            return B.mrope_tables(positions, self.rope_freqs,
                                  self.cfg.mrope_sections)
        return B.rope_tables(positions, self.rope_freqs)


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
    """tokens (B, S), with patch embeddings (B, P, d) prepended for a VLM
    -> (B, P + S, d) activations and positions: (B, P + S), or (B, P + S,
    3) under M-RoPE (``batch["positions3"]``, else the 1-D positions on
    all three streams)."""
    dev, dt = model.device, B.dtype_of(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    # F.embedding's gradient is a deterministic sorted segment sum, where
    # an index's serializes the rows a frequent token repeats
    x = F.embedding(tokens, model.embed).to(dt)
    if cfg.vision_patches and "patches" in batch:
        pe = torch.as_tensor(batch["patches"], device=dev).to(dt)
        x = torch.cat([pe @ model.patch_proj, x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=dev).expand(b, s)
    if cfg.mrope_sections is not None:
        if batch.get("positions3") is not None:
            positions = torch.as_tensor(batch["positions3"], device=dev)
        else:
            positions = torch.stack([positions] * 3, dim=-1)
    if cfg.pos == "abs":
        x = x + B.sincos(s, cfg.d_model, x.dtype, dev)
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


def forward(cfg: ModelCfg, model: DecoderLM, batch, *, remat=True):
    """Full-sequence forward.  Returns (logits (B, S, V), aux).  ``remat``:
    each layer's activations are recomputed in backward."""
    x, positions = embed_inputs(cfg, model, batch)
    rope = model.rope(positions)
    aux = torch.zeros((), dtype=torch.float32, device=model.device)

    def body(x, blk, w):
        x, _, a = _layer(cfg, blk, x, positions, rope, w, True)
        return x, a

    for blk, w in zip(model.blocks, layer_windows(cfg)):
        x, a = B.layer_call(body, x, blk, int(w), remat=remat)
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
    rope = model.rope(positions)
    ks, vs = [], []
    for blk, w in zip(model.blocks, layer_windows(cfg)):
        x, (k, v), _ = _layer(cfg, blk, x, positions, rope, int(w), False)
        ks.append(k)
        vs.append(v)
    return model.logits(x[:, -1:]), {"k": torch.stack(ks),
                                     "v": torch.stack(vs)}


def decode_step(cfg: ModelCfg, model: DecoderLM, token, cache,
                cache_len: int, positions3=None):
    """One-token decode.  token: (B, 1); ``positions3`` (B, 1, 3) under
    M-RoPE (None: ``cache_len`` on all three streams).  Writes slot
    ``cache_len`` of every layer's cache in place; returns (logits (B, 1,
    V), cache)."""
    cache_len = int(cache_len)
    dev = model.device
    token = torch.as_tensor(token, device=dev)
    x = model.embed[token].to(B.dtype_of(cfg))
    positions = torch.full(token.shape, cache_len, dtype=torch.int32,
                           device=dev)
    if cfg.mrope_sections is not None:
        positions = (torch.stack([positions] * 3, dim=-1)
                     if positions3 is None
                     else torch.as_tensor(positions3, device=dev))
    if cfg.pos == "abs":
        x = x + B.sincos_at(cache_len, cfg.d_model, x.dtype, dev)
    rope = model.rope(positions)
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
