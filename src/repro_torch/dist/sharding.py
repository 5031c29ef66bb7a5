"""Placement rules for the model zoo (params, activations, caches).

The port of ``repro/dist/sharding.py``.  Mesh vocabulary is fixed across
the tree (see ``launch/mesh.py``):

  * ``"data"``  — batch / FSDP axis (weights are also sliced along it, so
    no rank ever holds a full copy of a large tensor);
  * ``"model"`` — tensor-parallel axis (vocab, FFN hidden, attention
    heads, MoE experts);
  * ``"pod"``   — optional pure data-replication axis across pods.

A spec is a tuple with one entry a dimension: an axis name, a tuple of
two or more axis names, or None (a ``PartitionSpec``'s entries, one-name
tuples written as the name, as ``PartitionSpec`` writes them).
:func:`param_specs` is rule-based on a leaf's *path and shape*, not on a
per-arch table, so every config gets specs from the reference's three
invariants:

  1. a dimension is only sharded when the axis size divides it exactly;
  2. matmul weights put ``"model"`` on their parallel dimension
     (out-features for up/gate/qkv projections, in-features for
     ``down``/``wo``, the expert axis for MoE banks, the vocab axis for
     embedding/head);
  3. any leaf of 1 MiB or more is also FSDP-sharded on ``"data"`` along
     its largest remaining divisible dimension, so no leaf above 32 MiB is
     ever fully replicated.

The leaves are the reference's: a model's per-layer parameters are read
under the reference's paths with their layers stacked on a leading L axis
(``models/convert.py``'s mapping), so a spec is the spec of that stacked
leaf.  Only shapes are read, so a model built on ``device="meta"`` (no
storage) will do.  An impossible axis size (``2**62``) turns an axis off
through rule 1.  No FSDP runtime uses these specs yet; the rules are the
placement a runtime would follow, and the dry-run's collective bytes
(``launch/dryrun.py``) are those of a runtime that follows them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["act_specs", "cache_spec", "dp_axes", "param_specs",
           "stacked_shapes"]

DEFAULT_AXIS_SIZES = {"model": 16, "data": 16}
FSDP_MIN_BYTES = 1 << 20        # below this, replication is cheaper than comms

# projections whose parallel (model) dimension is the *input* features dim:
# they consume a model-sharded activation and produce the residual stream
_REDUCE_IN = {"down", "wo"}
# leaves that carry the vocabulary on some dimension
_VOCAB = {"embed", "head"}


def dp_axes(mesh) -> tuple:
    """Data-parallel axis names of a mesh, major-to-minor."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _entry(axes):
    """A spec entry: None, an axis name, or a tuple of two or more."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def stacked_shapes(named) -> dict:
    """``{reference path: (shape, dtype)}`` of a model's parameters (or a
    mapping of its parameter names to tensors), each stacked subtree's
    layers on a leading L axis: ``convert.stack_layers`` on ``meta`` views,
    so nothing is copied or allocated."""
    # imported here: the models import this package (the MoE layer's
    # collectives), so it must not import them at its own import
    from repro_torch.models.convert import stack_layers
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    return {path: (tuple(t.shape), t.dtype) for path, t in stack_layers(
        {n: t.to("meta") for n, t in named.items()}).items()}


def _leaf_spec(names: list, shape: tuple, itemsize: int, sizes: dict) -> tuple:
    nd = len(shape)
    name = names[-1] if names else ""
    assign: dict[int, str] = {}      # dim index -> axis name

    def fits(dim: int, axis: str) -> bool:
        n = sizes.get(axis, 0)
        return (0 <= dim < nd and dim not in assign
                and axis not in assign.values()
                and n > 1 and shape[dim] % n == 0)

    def take(dim: int, axis: str) -> bool:
        if fits(dim, axis):
            assign[dim] = axis
            return True
        return False

    # ---- rule 2: place the tensor-parallel axis -------------------------
    if nd >= 2:
        if "moe" in names and name in ("gate", "up", "down") and nd >= 3:
            take(nd - 3, "model")           # expert banks: shard the E axis
        elif name in _VOCAB:
            # vocab-parallel embedding / head: vocab is the larger dimension
            take(int(np.argmax(shape[-2:])) + nd - 2, "model")
        elif name in _REDUCE_IN:
            take(nd - 2, "model") or take(nd - 1, "model")
        else:
            take(nd - 1, "model") or take(nd - 2, "model")

    # ---- rule 3: FSDP on the largest remaining divisible dimension ------
    if int(np.prod(shape or (1,))) * itemsize >= FSDP_MIN_BYTES:
        for dim in sorted(range(nd), key=lambda d: -shape[d]):
            if take(dim, "data"):
                break

    return tuple(assign.get(d) for d in range(nd))


def param_specs(params, axis_sizes: dict | None = None) -> dict:
    """``{reference path (dotted): spec}`` for every leaf of the
    reference's tree of a model (or of a mapping of its parameter names
    to tensors): :func:`stacked_shapes`, then the rules.  ``axis_sizes``
    maps axis name -> rank count for the divisibility rule; the default
    is the 16x16 production pod."""
    sizes = dict(DEFAULT_AXIS_SIZES if axis_sizes is None else axis_sizes)
    return {path: _leaf_spec(path.split("."), shape, dtype.itemsize, sizes)
            for path, (shape, dtype) in stacked_shapes(params).items()}


def act_specs(mesh) -> dict:
    """Activation placement at the block boundaries: ``resid`` (B, S, d),
    ``tokens`` (T, d), ``logits`` (B, S, V) with the padded vocab on
    ``model``.  ``mesh`` rides along for the layers that run collectives
    (the MoE expert-parallel path).  Each rank of the port already holds
    its own data shard, so the specs are descriptive: nothing reshards an
    activation."""
    dp = _entry(dp_axes(mesh))
    tp = "model" if "model" in mesh.axis_names else None
    return {
        "mesh": mesh,
        "resid": (dp, None, None),
        "tokens": (dp, None),
        "logits": (dp, None, tp),
    }


# decode-state leaf kinds -> the leaf's rank, leading (L, B) included;
# the batch dim is the only one worth sharding for every family (head
# counts are often tiny and odd), so kinds only differ in rank here
_CACHE_RANK = {
    "kv": 5,        # (L, B, T, KV, Dh)
    "kvscale": 4,   # (L, B, T, KV)
    "xkv": 5,       # (L, B, enc_ctx, KV, Dh)
    "wkv": 5,       # (L, B, H, Dh, Dh)
    "vec": 3,       # (L, B, d)
    "conv": 4,      # (L, B, d_conv-1, di)
    "ssm": 4,       # (L, B, di, state)
}


def cache_spec(mesh, batch: int, kind: str = "kv") -> tuple:
    """Spec of one decode-cache leaf: batch on the DP axes when they
    divide it."""
    if kind not in _CACHE_RANK:
        raise KeyError(f"unknown cache kind {kind!r}; have {sorted(_CACHE_RANK)}")
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= mesh.shape[a]
    lead = _entry(dp) if batch % dp_size == 0 else None
    return (None, lead) + (None,) * (_CACHE_RANK[kind] - 2)
