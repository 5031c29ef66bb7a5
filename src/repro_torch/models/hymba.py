"""Hymba: a hybrid-head LM, attention and Mamba (SSM) heads in parallel.

The port of ``repro/models/hymba.py``.  Each block feeds the normed input
to both a GQA attention branch (a sliding window except on layers {0,
L/2, L-1}, which are global) and a selective-SSM (Mamba) branch; each
branch's output is normalised and the two are mixed with learned gates
beta.  The reference's ``lax.scan``s over time (the SSM recurrence) are
Python loops here; it has no Pallas kernel for them.

The decode state keeps the reference's layout: a KV cache ``k`` / ``v``
(L, B, max_len, KV, Dh) at ``max_len`` for every layer (windowed layers
only attend within their window), the conv tail ``conv`` (L, B, d_conv-1,
d_inner) in the model dtype and the SSM state ``ssm`` (L, B, d_inner, n)
in float32.  :func:`decode_step` writes it in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelCfg
from . import blocks as B
from .transformer import LM, _params


def _global_layers(cfg: ModelCfg):
    return {0, cfg.n_layers // 2, cfg.n_layers - 1}


def layer_windows(cfg: ModelCfg) -> np.ndarray:
    """Per-layer attention window (0 = global)."""
    w = np.full(cfg.n_layers, cfg.window or 1024, np.int32)
    for i in _global_layers(cfg):
        w[i] = 0
    return w


def _d_inner(cfg: ModelCfg) -> int:
    return cfg.ssm.expand * cfg.d_model


class Block(nn.Module):
    """One layer under the reference's names: ``ln1``, ``ln2``, ``attn``,
    ``mlp``, ``beta`` (float32) and ``ssm`` (``a_log``, ``d_skip`` and
    ``dt_bias`` in float32)."""

    def __init__(self, cfg: ModelCfg, gen, device):
        super().__init__()
        dt, f32 = B.dtype_of(cfg), torch.float32
        di, n, d = _d_inner(cfg), cfg.ssm.state_dim, cfg.d_model
        self.ln1 = _params(B.norm_params(cfg, device))
        self.ln2 = _params(B.norm_params(cfg, device))
        self.attn = _params(B.attn_params(cfg, gen, device))
        self.mlp = _params(B.mlp_params(cfg, gen, device))
        self.beta = nn.Parameter(torch.zeros((2,), dtype=f32, device=device),
                                 requires_grad=False)   # branch mix gates
        self.ssm = _params({
            "in_proj": B.dense_init(gen, d, 2 * di, dt, device),
            "conv_w": B.normal((cfg.ssm.d_conv, di), 0.2, dt, gen, device),
            "x_bc_dt": B.dense_init(gen, di, 2 * n + 1, dt, device),
            "a_log": torch.zeros((di, n), dtype=f32, device=device),
            "d_skip": torch.ones((di,), dtype=f32, device=device),
            "dt_bias": torch.full((di,), -4.0, dtype=f32, device=device),
            "out_proj": B.dense_init(gen, di, d, dt, device),
        })


class HymbaLM(LM):
    """The weights: ``embed``, ``blocks``, ``final_norm`` and ``head``;
    the vocab mask and the RoPE frequencies as buffers.  Drawn from
    ``generator``, or left uninitialised for :mod:`.convert`."""

    def __init__(self, cfg: ModelCfg, *, device="cuda", generator=None):
        super().__init__()
        dev = resolve_device(device)
        dt = B.dtype_of(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(
            B.normal((cfg.padded_vocab, cfg.d_model), 0.02, dt, generator,
                     dev), requires_grad=False)
        self.blocks = nn.ModuleList(Block(cfg, generator, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _params(B.norm_params(cfg, dev))
        self.head = nn.Parameter(
            B.dense_init(generator, cfg.d_model, cfg.padded_vocab, dt, dev),
            requires_grad=False)
        self.register_buffer("vocab_mask", B.vocab_mask(cfg, dt, dev),
                             persistent=False)
        self.register_buffer("rope_freqs", torch.as_tensor(
            B.rope_freqs(cfg.head_dim, cfg.rope_theta), dtype=torch.float32,
            device=dev), persistent=False)


def _ssm_scan(u, dt_, Bm, Cm, a, state):
    """The selective SSM.  u, dt_: (B, S, di); Bm, Cm: (B, S, n); a (di, n)
    negative; state (B, di, n).  Returns (y (B, S, di), state)."""
    da = torch.exp(dt_[..., None] * a)                  # (B, S, di, n) decay
    dbu = dt_[..., None] * Bm[:, :, None, :] * u[..., None]
    ys = []
    for t in range(u.shape[1]):
        state = state * da[:, t] + dbu[:, t]
        ys.append(torch.einsum("bdn,bn->bd", state, Cm[:, t]))
    return torch.stack(ys, dim=1), state


def _mamba_branch(cfg: ModelCfg, p, x, conv_tail, ssm_state):
    """x: (B, S, d); conv_tail (B, d_conv-1, di): the inputs before x.
    Returns (y, new tail, new SSM state)."""
    s = x.shape[1]
    n = cfg.ssm.state_dim
    u, z = (x @ p["in_proj"]).chunk(2, dim=-1)           # (B, S, di) each
    # depthwise causal conv over time, its bf16 products summed in the
    # reference's order
    upad = torch.cat([conv_tail.to(u.dtype), u], dim=1)
    dc = p["conv_w"].shape[0]
    conv = sum(upad[:, i:i + s] * p["conv_w"][i] for i in range(dc))
    u = F.silu(conv)
    new_tail = upad[:, upad.shape[1] - (dc - 1):]
    bcdt = (u @ p["x_bc_dt"]).float()
    Bm, Cm, dt_ = bcdt[..., :n], bcdt[..., n:2 * n], bcdt[..., 2 * n]
    dt_ = F.softplus(dt_[..., None] + p["dt_bias"])      # (B, S, di)
    a = -torch.exp(p["a_log"])                           # (di, n)
    y, ssm_state = _ssm_scan(u.float(), dt_, Bm, Cm, a, ssm_state)
    y = y + u.float() * p["d_skip"]
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y, new_tail, ssm_state


def _norm_free(v, eps=1e-5):
    v32 = v.float()
    return (v32 * torch.rsqrt(v32.var(-1, keepdim=True, unbiased=False)
                              + eps)).to(v.dtype)


def _mix(blk: Block, x, attn, mam):
    """The residual plus the branches' gated mix.  The gates are float32,
    so the mix is too (the reference's dtypes promote so)."""
    beta = torch.sigmoid(blk.beta)
    mix = (beta[0] * _norm_free(attn).float()
           + beta[1] * _norm_free(mam).float())
    return x + mix.to(x.dtype)


def init_state(cfg: ModelCfg, batch, max_len, device="cuda"):
    """Decode state: KV cache, conv tail and SSM state of every layer."""
    dev = resolve_device(device)
    dt = B.dtype_of(cfg)
    di = _d_inner(cfg)
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dt, device=dev),
        "v": torch.zeros(kv, dtype=dt, device=dev),
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm.d_conv - 1, di),
                            dtype=dt, device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, di, cfg.ssm.state_dim),
                           dtype=torch.float32, device=dev),
    }


def forward(cfg: ModelCfg, model: HymbaLM, batch):
    """Over a whole sequence, each Mamba branch from a zero tail and
    state.  Returns (logits (B, S, V), aux 0)."""
    dev, dt = model.device, B.dtype_of(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    b, s = tokens.shape
    x = model.embed[tokens].to(dt)
    positions = torch.arange(s, device=dev).expand(b, s)
    rope = B.rope_tables(positions, model.rope_freqs)
    di, n = _d_inner(cfg), cfg.ssm.state_dim
    for blk, w in zip(model.blocks, layer_windows(cfg)):
        h = B.apply_norm(cfg, blk.ln1, x)
        q, k, v = B._qkv(cfg, blk.attn, h, positions, rope)
        attn = B.attend(q, k, v, int(w), cfg).reshape(b, s, -1) \
            @ blk.attn["wo"]
        tail0 = torch.zeros((b, cfg.ssm.d_conv - 1, di), dtype=x.dtype,
                            device=dev)
        st0 = torch.zeros((b, di, n), dtype=torch.float32, device=dev)
        mam = _mamba_branch(cfg, blk.ssm, h, tail0, st0)[0]
        x = _mix(blk, x, attn, mam)
        x = x + B.apply_mlp(cfg, blk.mlp, B.apply_norm(cfg, blk.ln2, x))
    return model.logits(x), torch.zeros((), dtype=torch.float32, device=dev)


def decode_step(cfg: ModelCfg, model: HymbaLM, token, state, cache_len: int):
    """One-token decode.  token: (B, 1).  Writes slot ``cache_len`` of the
    KV cache, the conv tails and the SSM states in place; returns (logits
    (B, 1, V), state)."""
    cache_len = int(cache_len)
    dev = model.device
    token = torch.as_tensor(token, device=dev)
    x = model.embed[token].to(B.dtype_of(cfg))
    positions = torch.full(token.shape, cache_len, dtype=torch.int32,
                           device=dev)
    rope = B.rope_tables(positions, model.rope_freqs)
    t = state["k"].shape[2]
    for i, (blk, w) in enumerate(zip(model.blocks, layer_windows(cfg))):
        h = B.apply_norm(cfg, blk.ln1, x)
        win = int(w) if w > 0 else t + 1
        attn = B.decode_attention(cfg, blk.attn, h, positions,
                                  state["k"][i], state["v"][i], cache_len,
                                  window=win, rope=rope)[0]
        mam, tail, sst = _mamba_branch(cfg, blk.ssm, h, state["conv"][i],
                                       state["ssm"][i])
        state["conv"][i], state["ssm"][i] = tail, sst
        x = _mix(blk, x, attn, mam)
        x = x + B.apply_mlp(cfg, blk.mlp, B.apply_norm(cfg, blk.ln2, x))
    return model.logits(x), state
