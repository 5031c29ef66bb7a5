"""Mixture-of-Experts layer: routing runs on the paper's selection engine.

The port of ``repro/models/moe.py``'s single-device ("auto") path:

  * **router top-k**: per-token top-k over expert probabilities goes
    through :func:`repro_torch.kernels.radix_topk.radix_topk`, the radix
    threshold kernel on the card and its plain version on the host;
  * **sort-based dispatch**: tokens are ordered by expert id and packed
    into per-expert capacity buffers, ``C = max(256, ceil(T*k/E * cf))``
    rounded up to 256; overflow tokens are dropped (their residual passes
    through).  Expert count is padded to a multiple of 16 (granite's 40 ->
    48); the dead experts are never routed to.

The combine differs from the reference's ``.at[stok].add`` in order only:
the twin of that scatter on the card, ``index_add_``, adds with atomics,
so its bf16 sums would change from run to run.  Here each token's
``top_k`` contributions are gathered back to choice order and summed by
one reduction, the same every run.

Under autograd the router's weights learn only through the load-balance
aux loss, as the reference's do: its radix top-k values carry no
gradient (see :func:`_route`).  The sharded expert path (``shard_map``
over a ``model`` axis) is ROADMAP Queue 1 item 4.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.kernels.radix_topk import radix_topk
from .blocks import activation, dtype_of, normal


def padded_experts(cfg: ModelCfg, n_model: int = 16) -> int:
    e = cfg.moe.n_experts
    return -(-e // n_model) * n_model


def moe_params(cfg: ModelCfg, gen, device) -> dict:
    """The router stays float32 whatever ``cfg.dtype`` (as the
    reference's); expert weights are stored for the padded count."""
    m = cfg.moe
    dt = dtype_of(cfg)
    e, d, de = padded_experts(cfg), cfg.d_model, m.d_expert
    scale = 1.0 / np.sqrt(d)
    return {
        "router": normal((d, m.n_experts), scale, torch.float32, gen, device),
        "gate": normal((e, d, de), scale, dt, gen, device),
        "up": normal((e, d, de), scale, dt, gen, device),
        "down": normal((e, de, d), 1.0 / np.sqrt(de), dt, gen, device),
    }


def capacity(cfg: ModelCfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(np.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    # multiple of 256 so the capacity dim shards over any DP degree <= 256
    return max(256, -(-c // 256) * 256)


def _route(cfg: ModelCfg, router, xf):
    """(T, d) -> (gate weights (T,k), expert ids (T,k), probs (T,E))."""
    m = cfg.moe
    logits = xf.float() @ router
    probs = torch.softmax(logits, dim=-1)
    if m.router_use_radix:
        # the reference's kernel returns its values through a bitcast, so
        # they carry no gradient: the router learns through the aux loss
        gate_vals, expert_idx = radix_topk(probs.detach(), m.top_k,
                                           device=probs.device)
    else:
        gate_vals, expert_idx = torch.topk(probs, m.top_k)
    weights = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return weights, expert_idx, probs


def _counts(ids: torch.Tensor, length: int) -> torch.Tensor:
    """``bincount`` of ``ids`` (all < ``length``) without its host sync."""
    ids = ids.reshape(-1).long()
    return torch.zeros(length, dtype=torch.int64, device=ids.device) \
        .scatter_add_(0, ids, torch.ones_like(ids))


class _Rows(torch.autograd.Function):
    """``src[idx]`` over rows, whose backward writes each row's gradient
    back in place (``index_put_`` without accumulation).  Exact where
    ``idx`` repeats no row whose gradient is used: the dispatch's
    permutations, and the spare row every dropped entry reads, whose
    gradient is cut off.  Autograd's own gradient of an index accumulates
    with a sort-based kernel that serializes repeated rows (60 % of a
    granite-moe-3b-a800m train step on an H100, ``PERF.md``), and
    ``index_add_`` adds in an order that changes from run to run."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.src_shape = src.shape
        return src[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros(ctx.src_shape)
        out[idx] = grad
        return out, None


def _rows(src, idx):
    """``src[idx]``, through :class:`_Rows` when autograd records it (a
    serving call pays for no autograd function)."""
    if torch.is_grad_enabled() and src.requires_grad:
        return _Rows.apply(src, idx)
    return src[idx]


def _dispatch_compute(cfg, p, xf, weights, expert_idx, e_lo, e_count, c):
    """Pack tokens routed to experts [e_lo, e_lo+e_count) into capacity
    buffers, run the expert FFNs, and combine back per token."""
    k = cfg.moe.top_k
    t, d = xf.shape
    tk = t * k
    dev = xf.device
    flat_e = expert_idx.reshape(tk).long()
    flat_w = weights.reshape(tk).to(xf.dtype)
    order = torch.argsort(flat_e, stable=True)               # tokens by expert
    se, sw = flat_e[order], flat_w[order]
    counts = _counts(flat_e, padded_experts(cfg))
    offsets = torch.cumsum(counts, 0) - counts               # exclusive
    rank = torch.arange(tk, device=dev) - offsets[se]
    local = (se >= e_lo) & (se < e_lo + e_count)
    keep = (rank < c) & local
    slot = torch.where(keep, (se - e_lo) * c + rank, e_count * c)

    # dropped entries all write the spare last row, which is cut off
    buf = xf.new_zeros((e_count * c + 1, d))
    if torch.is_grad_enabled() and xf.requires_grad:
        # each token once per choice, then in expert order: a permutation
        xs = _Rows.apply(xf[:, None].expand(t, k, d).reshape(tk, d), order)
    else:
        xs = xf[order // k]                  # the token of each choice
    buf[slot] = xs * keep[:, None].to(xf.dtype)
    buf = buf[:-1].reshape(e_count, c, d)

    act = activation(cfg)
    h = act(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    y = torch.bmm(h, p["down"])

    yf = torch.cat([y.reshape(e_count * c, d), y.new_zeros((1, d))])
    contrib = _rows(yf, slot) * sw[:, None]                  # (TK, d) sorted
    inv = torch.empty_like(order)
    inv[order] = torch.arange(tk, device=dev)
    return _rows(contrib, inv).reshape(t, k, d).sum(1)


def apply_moe(cfg: ModelCfg, p, x, *, mesh=None, need_aux=True):
    """x: (B, S, d) -> ((B, S, d), aux), aux the router load-balance loss
    (None when ``need_aux`` is False: serving drops it, as the reference's
    compiled serving steps do)."""
    if mesh is not None:
        raise NotImplementedError("the sharded expert path is not ported "
                                  "yet: ROADMAP Queue 1 item 4")
    return _apply_moe_auto(cfg, p, x, need_aux)


def _aux_loss(cfg, probs, expert_idx):
    m = cfg.moe
    me = probs.mean(0)
    fe = _counts(expert_idx, m.n_experts).float() / expert_idx.numel()
    return m.n_experts * (fe * me).sum()


def _apply_moe_auto(cfg: ModelCfg, p, x, need_aux=True):
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    weights, expert_idx, probs = _route(cfg, p["router"], xf)
    c = capacity(cfg, t)
    out = _dispatch_compute(cfg, p, xf, weights, expert_idx,
                            0, padded_experts(cfg), c)
    aux = _aux_loss(cfg, probs, expert_idx) if need_aux else None
    return out.reshape(b, s, d), aux
