"""RWKV-6 "Finch": an attention-free LM with data-dependent decay.

The port of ``repro/models/rwkv6.py``.  Per head (head_dim n) a recurrent
WKV state S in R^{n x n}:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(decay_t)) a per-channel decay that depends on the
data, and u a learned per-channel bonus.  A token shift (a lerp of
x_{t-1} and x_t) feeds the r/k/v/g/decay projections; the channel mix is
the squared-ReLU FFN with its own token shift.

The reference's ``lax.scan`` over time is a Python loop over time here
(the reference has no Pallas kernel for it).  The state keeps its
reference layout, a dict of ``wkv`` (L, B, H, n, n) float32 and the
token-shift rows ``x_tm`` / ``x_cm`` (L, B, d) in the model dtype: the
*normed* inputs' last rows.  :func:`decode_step` writes it in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelCfg
from . import blocks as B
from .transformer import LM, _params

LORA = 64                                  # decay LoRA rank (Finch)


class Block(nn.Module):
    """One layer under the reference's names: ``ln1``, ``ln2``, ``mix``
    (the time mix; ``w0``, ``u`` and ``gn`` in float32) and ``ffn``."""

    def __init__(self, cfg: ModelCfg, gen, device):
        super().__init__()
        d, dt, f32 = cfg.d_model, B.dtype_of(cfg), torch.float32

        def dense(i, o):
            return B.dense_init(gen, i, o, dt, device)

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        self.ln1 = _params(B.norm_params(cfg, device))
        self.ln2 = _params(B.norm_params(cfg, device))
        self.mix = _params({
            "mu": full((5, d), 0.5, dt),   # token-shift lerp for r,k,v,g,w
            "wr": dense(d, d), "wk": dense(d, d), "wv": dense(d, d),
            "wg": dense(d, d), "wo": dense(d, d),
            "w1": dense(d, LORA),                        # decay LoRA
            "w2": B.normal((LORA, d), 0.01, dt, gen, device),
            "w0": full((d,), -5.0, f32),                 # decay bias
            "u": full((cfg.n_heads, cfg.head_dim), 0.0, f32),   # bonus
            "gn": full((d,), 1.0, f32),                  # group-norm scale
        })
        self.ffn = _params({
            "mu": full((2, d), 0.5, dt),
            "wk": dense(d, cfg.d_ff), "wv": dense(cfg.d_ff, d),
            "wr": dense(d, d),
        })


class RWKV6LM(LM):
    """The weights: ``embed``, ``blocks``, ``final_norm`` and ``head``
    (d, padded_vocab); the vocab mask as a buffer.  Drawn from
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


def _shift(x, x_prev):
    """Token shift: the x_{t-1} stream of x (B, S, d), x_prev first."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _wkv_scan(r, k, v, w, u, state):
    """r, k, v, w: (B, S, H, n) float32, w the decay in (0, 1); u (H, n);
    state (B, H, n, n).  Returns (out (B, S, H, n), state)."""
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # outer product
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = state * w[:, t, ..., None] + kv
    return torch.stack(outs, dim=1), state


def _time_mix(cfg: ModelCfg, p, x, x_prev, state):
    b, s, d = x.shape
    n_h, hd = cfg.n_heads, cfg.head_dim
    xs = _shift(x, x_prev)

    def lerp(i):
        return x + (xs - x) * p["mu"][i]

    r = (lerp(0) @ p["wr"]).reshape(b, s, n_h, hd).float()
    k = (lerp(1) @ p["wk"]).reshape(b, s, n_h, hd).float()
    v = (lerp(2) @ p["wv"]).reshape(b, s, n_h, hd).float()
    g = F.silu(lerp(3) @ p["wg"])
    decay = p["w0"] + (torch.tanh(lerp(4) @ p["w1"]) @ p["w2"]).float()
    w = torch.exp(-torch.exp(decay)).reshape(b, s, n_h, hd)
    out, state = _wkv_scan(r, k, v, w, p["u"], state)
    # per-head group norm
    out = (out - out.mean(-1, keepdim=True)) * torch.rsqrt(
        out.var(-1, keepdim=True, unbiased=False) + 1e-5)
    out = (out.reshape(b, s, d) * p["gn"]).to(x.dtype)
    return (out * g) @ p["wo"], x[:, -1], state


def _channel_mix(p, x, x_prev):
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * p["mu"][0]
    xr = x + (xs - x) * p["mu"][1]
    k = torch.square(torch.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1]


def init_state(cfg: ModelCfg, batch, device="cuda"):
    """The recurrent state (the 'cache' of an attention-free arch)."""
    dev = resolve_device(device)
    dt = B.dtype_of(cfg)
    return {
        "wkv": torch.zeros((cfg.n_layers, batch, cfg.n_heads, cfg.head_dim,
                            cfg.head_dim), dtype=torch.float32, device=dev),
        "x_tm": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=dt,
                            device=dev),
        "x_cm": torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=dt,
                            device=dev),
    }


def forward(cfg: ModelCfg, model: RWKV6LM, batch, state=None):
    """Over a whole sequence from ``state`` (None: zeros), which it
    updates in place.  Returns (logits (B, S, V), state)."""
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    x = model.embed[tokens].to(B.dtype_of(cfg))
    st = state if state is not None else init_state(cfg, tokens.shape[0],
                                                    model.device)
    for i, blk in enumerate(model.blocks):
        h = B.apply_norm(cfg, blk.ln1, x)
        out, x_tm, wkv = _time_mix(cfg, blk.mix, h, st["x_tm"][i],
                                   st["wkv"][i])
        x = x + out
        h2 = B.apply_norm(cfg, blk.ln2, x)
        out2, x_cm = _channel_mix(blk.ffn, h2, st["x_cm"][i])
        x = x + out2
        st["wkv"][i], st["x_tm"][i], st["x_cm"][i] = wkv, x_tm, x_cm
    return model.logits(x), st


def decode_step(cfg: ModelCfg, model: RWKV6LM, token, state,
                cache_len=None):
    """O(1) decode: :func:`forward` over one token (B, 1), carrying the
    state (in place).  Returns (logits (B, 1, V), state)."""
    return forward(cfg, model, {"tokens": token}, state=state)
