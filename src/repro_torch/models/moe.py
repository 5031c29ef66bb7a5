"""Mixture-of-Experts layer: routing runs on the paper's selection engine.

The port of ``repro/models/moe.py``:

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

Granite's published layer (``GraniteCfg.dropless``, a configuration of
the port alone) has a third, :func:`_apply_moe_dropless`: top-k of the
router's logits through the same radix kernel, softmax over the k, and
every routed entry computed, each expert over exactly its routed rows by
a grouped GEMM (``torch._grouped_mm``, its group ends on the device, so
no host synchronisation), over the real experts only (no padding, no
capacity, no drop).

Two dispatch paths, as in the reference:

  * ``auto``: every expert on this rank (one card, or the CPU);
  * ``sharded``, expert parallelism over a mesh with a ``model`` axis
    (``act_specs["mesh"]``): each rank holds its data
    shard's tokens, and the ranks of one ``model`` row the same tokens,
    so each routes them itself (a radix launch on every rank), selects
    the tokens routed to *its* experts ``[col*e_loc, (col+1)*e_loc)`` of
    the padded count (zero dispatch communication), runs their GEMMs, and
    one ``psum`` over ``model`` combines the outputs.  A rank may hold
    every expert or only its own (:func:`shard_experts`).

Under autograd the router's weights learn only through the load-balance
aux loss, as the reference's do: its radix top-k values carry no
gradient (see :func:`_route`).  The sharded path trains too: the tokens
and the gate weights enter a rank's dispatch through
:func:`~repro_torch.dist._comm.copy_to`, so their gradients are the sum
of every model rank's experts' parts; the output's ``psum`` and the
aux's ``pmean`` pass their cotangents through.  The router, which each
model rank runs whole, then gets the same gradient on every model rank,
and each rank's gradient is that of the single-rank layer on its data
shard, its own experts' slices included (a data-parallel step averages
them over the data ranks).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.dist._comm import (axis_index, copy_to, pmean_replicated,
                                    psum_replicated)
from repro_torch.dist.sharding import dp_axes
from repro_torch.kernels.radix_topk import radix_topk
from repro_torch.obs.tracer import NO_STAGES
from .blocks import activation, dtype_of, normal


def padded_experts(cfg: ModelCfg, n_model: int = 16) -> int:
    e = cfg.moe.n_experts
    return -(-e // n_model) * n_model


def dropless(cfg: ModelCfg) -> bool:
    """Whether the configuration's MoE layer is dropless (granite's)."""
    return getattr(cfg, "dropless", False)


def moe_params(cfg: ModelCfg, gen, device) -> dict:
    """The router stays float32 whatever ``cfg.dtype`` (as the
    reference's); expert weights are stored for the padded count.  A
    dropless layer stores its real experts only, the gate and up
    projections side by side in ``gate_up`` (E, d, 2 de), gate first, as
    HF's ``input_linear`` holds them."""
    m = cfg.moe
    dt = dtype_of(cfg)
    e, d, de = padded_experts(cfg), cfg.d_model, m.d_expert
    scale = 1.0 / np.sqrt(d)
    if dropless(cfg):
        e = m.n_experts
        return {
            "router": normal((d, e), scale, torch.float32, gen, device),
            "gate_up": normal((e, d, 2 * de), scale, dt, gen, device),
            "down": normal((e, de, d), 1.0 / np.sqrt(de), dt, gen, device),
        }
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


def apply_moe(cfg: ModelCfg, p, x, *, act_specs=None, need_aux=True,
              obs=None, span="moe"):
    """x: (B, S, d) -> ((B, S, d), aux), aux the router load-balance loss
    (None when ``need_aux`` is False: serving drops it, as the reference's
    compiled serving steps do).  ``act_specs`` whose mesh has a ``model``
    axis takes the expert-parallel path, as the reference's does (with one
    ``model`` rank its ``psum`` is the identity and the aux is still
    ``pmean``-ed over the data axes).  A dropless configuration takes
    :func:`_apply_moe_dropless`, on one rank only; ``obs`` (the serving
    model: its ``stages`` and ``counters``) and ``span`` name that path's
    spans and counters."""
    mesh = act_specs.get("mesh") if act_specs else None
    sharded = mesh is not None and "model" in mesh.axis_names
    if dropless(cfg):
        if sharded:
            raise ValueError(f"{cfg.name}: the dropless MoE layer runs on "
                             "one rank; it has no expert-parallel path")
        return _apply_moe_dropless(cfg, p, x, need_aux, obs, span)
    if sharded:
        return _apply_moe_sharded(cfg, p, x, mesh, need_aux)
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


# ------------------------------------------------------------ dropless

def route_logits(cfg: ModelCfg, router, xf):
    """Granite's router: top-k of the router's float32 logits through the
    radix kernel, then softmax over the k -> (gate weights (T, k) float32,
    expert ids (T, k)).  The same as softmax over every expert, top-k and
    renormalising, with one softmax over k columns in place of one over E
    and a sum."""
    logits = xf.float() @ router
    vals, ids = radix_topk(logits, cfg.moe.top_k, device=logits.device)
    return torch.softmax(vals, dim=-1), ids


def expert_ffn(cfg: ModelCfg, xs, gate_up, down, ends):
    """Every expert's SwiGLU over exactly its rows: ``xs`` (N, d) sorted by
    expert, expert e's rows ``[ends[e-1], ends[e])`` (``ends`` int32 on
    ``xs``'s device, the groups' ends) -> (N, d).  Two grouped GEMMs
    (``torch._grouped_mm``: bf16 on the card, any float on the host)."""
    h = torch._grouped_mm(xs, gate_up, offs=ends)
    g, u = h.chunk(2, dim=-1)
    return torch._grouped_mm(activation(cfg)(g) * u, down, offs=ends)


def _apply_moe_dropless(cfg: ModelCfg, p, x, need_aux=True, obs=None,
                        span="moe"):
    """Granite's dropless layer: route (:func:`route_logits`), sort the
    T k entries by expert (stable: token order within an expert), gather
    their rows, run :func:`expert_ffn` over the real experts, weigh each
    entry by its gate and sum each token's k entries back in choice order
    (in float32, one reduction, the same every run).  Nothing here waits
    for the card.  ``need_aux``: the load-balance loss on the softmax
    over every expert, as the capacity path's.  Spans: ``<span>.route``,
    ``.dispatch``, ``.experts``, ``.combine``; counters ``<span>.passes``,
    ``.entries``, ``.max_load`` (the most-loaded expert's entries, summed
    over passes) and ``.experts_hit`` (experts with an entry)."""
    stages = NO_STAGES if obs is None else obs.stages
    m = cfg.moe
    b, s, d = x.shape
    t, k = b * s, m.top_k
    xf = x.reshape(t, d)
    with stages.stage(f"{span}.route"):
        weights, ids = route_logits(cfg, p["router"], xf)
    with stages.stage(f"{span}.dispatch"):
        flat = ids.reshape(t * k).long()
        order = torch.argsort(flat, stable=True)
        counts = _counts(flat, m.n_experts)
        ends = torch.cumsum(counts, 0).to(torch.int32)
        xs = xf[order // k]
    with stages.stage(f"{span}.experts"):
        ys = expert_ffn(cfg, xs, p["gate_up"], p["down"], ends)
    with stages.stage(f"{span}.combine"):
        contrib = ys.float() * weights.reshape(t * k)[order, None]
        out = torch.empty_like(contrib)
        out[order] = contrib                 # a permutation: no adds
        out = out.reshape(t, k, d).sum(1).to(x.dtype)
    if obs is not None:
        # a pass's entries are a shape, counted on the host; the loads are
        # accumulated on the device, read only at a snapshot
        ctr = obs.counters
        ctr.add(f"{span}.passes", 1)
        ctr.add(f"{span}.entries", t * k)
        ctr.add(f"{span}.max_load", counts.amax())
        ctr.add(f"{span}.experts_hit", counts.count_nonzero())
    aux = None
    if need_aux:
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)
        aux = _aux_loss(cfg, probs, ids)
    return out.reshape(b, s, d), aux


# ------------------------------------------------------ expert parallelism

def expert_slice(cfg: ModelCfg, mesh) -> tuple:
    """``(first, count)`` of this rank's experts of the padded count on
    ``mesh``'s ``model`` axis."""
    e_pad, n_model = padded_experts(cfg), mesh.shape["model"]
    if e_pad % n_model:
        raise ValueError(f"{cfg.name}: the model axis ({n_model} ranks) "
                         f"does not divide the {e_pad} padded experts")
    e_loc = e_pad // n_model
    return axis_index(mesh, "model") * e_loc, e_loc


def _local_experts(cfg: ModelCfg, p, mesh) -> dict:
    lo, count = expert_slice(cfg, mesh)
    held = p["gate"].shape[0]
    if held == count:                    # only this rank's (shard_experts)
        return {k: p[k] for k in ("gate", "up", "down")}
    if held != padded_experts(cfg):
        raise ValueError(f"{cfg.name}: {held} experts held, neither the "
                         f"{padded_experts(cfg)} padded nor this rank's "
                         f"{count}")
    return {k: p[k][lo:lo + count] for k in ("gate", "up", "down")}


def is_expert_leaf(name: str) -> bool:
    """Whether the parameter ``name`` holds experts, the leaves an
    expert-parallel rank holds only in part."""
    head, _, leaf = name.rpartition(".")
    return head.endswith("moe") and leaf in ("gate", "up", "down")


def shard_experts(cfg: ModelCfg, model, mesh):
    """Keep only this rank's experts in every MoE block of ``model``, in
    place (the rest is freed); returns the model."""
    for blk in model.blocks:
        if hasattr(blk, "moe"):
            local = _local_experts(cfg, blk.moe, mesh)
            for k, t in local.items():
                blk.moe[k] = torch.nn.Parameter(
                    t.detach().clone(), requires_grad=t.requires_grad)
    return model


def _apply_moe_sharded(cfg: ModelCfg, p, x, mesh, need_aux=True):
    """EP on this rank: local route, local expert select and GEMMs, one
    ``psum`` over ``model``; the aux ``pmean``-ed over every axis.  Under
    autograd the dispatch's inputs sum their gradients over ``model``
    (see the head of this module)."""
    lo, count = expert_slice(cfg, mesh)
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    weights, expert_idx, probs = _route(cfg, p["router"], xf)
    c = capacity(cfg, t)
    out = _dispatch_compute(cfg, _local_experts(cfg, p, mesh),
                            copy_to(xf, mesh, "model"),
                            copy_to(weights, mesh, "model"), expert_idx, lo,
                            count, c)
    out = psum_replicated(out, mesh, "model")
    aux = (pmean_replicated(_aux_loss(cfg, probs, expert_idx), mesh,
                            dp_axes(mesh) + ("model",)) if need_aux else None)
    return out.reshape(b, s, d), aux
