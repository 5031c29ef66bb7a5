"""Carry weights between the reference's tree and the port's models.

:func:`from_reference` takes the tree that the reference's ``api.init``
returns, as numpy arrays (``jax.tree.map(np.asarray, params)``), with the
stacked layers' leading L axis (``layers``; Whisper's ``enc_layers`` and
``dec_layers``), and returns the family's model on a given device.  The
port keeps the reference's ``(in, out)`` weight layout, so nothing is
transposed; granite's padded expert rows (48 stored for 40 routed) are
kept, and the float32 leaves of a bf16 model (the router, RWKV-6's
``w0``/``u``/``gn``, Hymba's gates and SSM constants) stay float32.  The
tree must hold exactly the model's parameters, each of the model's shape
and dtype.  :func:`to_reference` is its inverse: a model, or an optimizer
slot keyed by the model's parameter names, as the reference's tree of
numpy arrays, its layers stacked again.  bf16 leaves come out as
``|V2`` arrays of their raw bits, which is what ``np.savez`` writes for
the reference's ``ml_dtypes`` bf16 (the port needs no ``ml_dtypes``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from .api import model_class

# the reference's stacked subtrees -> the port's ModuleLists
STACKED = {"layers": "blocks", "enc_layers": "enc_blocks",
           "dec_layers": "dec_blocks"}


# the reference's bf16 leaves as np.savez writes them (ml_dtypes' bfloat16
# has no numpy descriptor, so the bytes go out as a 2-byte void)
BF16_BITS = np.dtype("V2")


def to_torch(a) -> torch.Tensor:
    """A numpy array as a CPU tensor.  bf16 arrays (``ml_dtypes``, what
    ``np.asarray`` gives for a jax bf16 array, or ``|V2`` bits read back
    from an ``.npz``) go through an int16 view, since ``torch.from_numpy``
    refuses their dtype."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))     # 0-d stays 0-d
    if a.dtype.name == "bfloat16" or a.dtype == BF16_BITS:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor as a host numpy array (no memory shared with
    the tensor, which training goes on updating); bf16 as ``|V2`` bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _leaves(tree, cfg: ModelCfg):
    """(port parameter name, numpy leaf) for every leaf of a reference
    tree, the stacked subtrees split by layer."""
    for name, leaf in _flatten(tree):
        top, _, rest = name.partition(".")
        if top not in STACKED:
            yield name, leaf
            continue
        n = cfg.n_enc_layers if top == "enc_layers" else cfg.n_layers
        if len(leaf) != n:
            raise ValueError(f"{name}: {len(leaf)} layers, config has {n}")
        for i in range(n):
            yield f"{STACKED[top]}.{i}.{rest}", leaf[i]


def load_tree(cfg: ModelCfg, named, tree, *, cast=False) -> None:
    """Copy a reference tree (numpy leaves) into ``named``, a mapping of
    the port's parameter names to tensors (a model's parameters or an
    optimizer slot), in place.  Every name must be covered, each leaf of
    its tensor's shape, and of its dtype unless ``cast``."""
    want = set()
    for pname, arr in _leaves(tree, cfg):
        if pname not in named:
            raise KeyError(f"{pname}: not a parameter of the port's "
                           f"{cfg.name}")
        dst = named[pname]
        t = to_torch(arr)
        if t.shape != dst.shape or (t.dtype != dst.dtype and not cast):
            raise ValueError(f"{pname}: reference {tuple(t.shape)} "
                             f"{t.dtype}, port {tuple(dst.shape)} "
                             f"{dst.dtype}")
        with torch.no_grad():
            dst.copy_(t)
        want.add(pname)
    missing = sorted(set(named) - want)
    if missing:
        raise KeyError(f"parameters absent from the reference tree: "
                       f"{missing}")


def from_reference(cfg: ModelCfg, tree, *, device="cuda"):
    """The reference's parameter tree (numpy leaves) as a port model."""
    model = model_class(cfg)(cfg, device=device)
    load_tree(cfg, dict(model.named_parameters()), tree)
    return model


def to_reference(cfg: ModelCfg, named) -> dict:
    """A model (its parameters), or a mapping of its parameter names to
    tensors (an optimizer slot), as the reference's nested tree of numpy
    arrays: the blocks stacked on a leading L axis under the reference's
    names (``layers``; Whisper's ``enc_layers`` and ``dec_layers``)."""
    if isinstance(named, torch.nn.Module):
        named = dict(named.named_parameters())
    port_to_ref = {v: k for k, v in STACKED.items()}
    tree, stacks = {}, {}
    for name, t in named.items():
        top, _, rest = name.partition(".")
        if top in port_to_ref:
            i, _, rest = rest.partition(".")
            stacks.setdefault((port_to_ref[top], rest), {})[int(i)] = t
            continue
        _put(tree, name, to_numpy(t))
    for (top, rest), layers in stacks.items():
        n = cfg.n_enc_layers if top == "enc_layers" else cfg.n_layers
        if sorted(layers) != list(range(n)):
            raise ValueError(f"{top}.{rest}: layers {sorted(layers)}, "
                             f"config has {n}")
        _put(tree, f"{top}.{rest}",
             np.stack([to_numpy(layers[i]) for i in range(n)]))
    return tree


def _put(tree: dict, dotted: str, leaf) -> None:
    *path, last = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[last] = leaf
