"""Carry the reference's weights into the port.

:func:`from_reference` takes the tree that the reference's ``api.init``
returns, as numpy arrays (``jax.tree.map(np.asarray, params)``), with the
stacked layers' leading L axis, and returns a :class:`DecoderLM` on a
given device.  The port keeps the reference's ``(in, out)`` weight layout,
so nothing is transposed; granite's padded expert rows (48 stored for 40
routed) are kept, and the router stays float32.  The tree must hold
exactly the model's parameters, each of the model's shape and dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from .transformer import DecoderLM


def to_torch(a) -> torch.Tensor:
    """A numpy array as a CPU tensor.  bf16 arrays (``ml_dtypes``, what
    ``np.asarray`` gives for a jax bf16 array) go through an int16 view,
    since ``torch.from_numpy`` refuses their dtype."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def from_reference(cfg: ModelCfg, tree, *, device="cuda") -> DecoderLM:
    """The reference's parameter tree (numpy leaves) as a port model."""
    model = DecoderLM(cfg, device=device)
    params = dict(model.named_parameters())
    want = set()
    for name, leaf in _flatten(tree):
        if name.startswith("layers."):
            rest = name[len("layers."):]
            if len(leaf) != cfg.n_layers:
                raise ValueError(f"{name}: {len(leaf)} layers, config has "
                                 f"{cfg.n_layers}")
            pairs = [(f"blocks.{i}.{rest}", leaf[i])
                     for i in range(cfg.n_layers)]
        else:
            pairs = [(name, leaf)]
        for pname, arr in pairs:
            if pname not in params:
                raise KeyError(f"{pname}: not a parameter of the port's "
                               f"{cfg.name}")
            p = params[pname]
            t = to_torch(arr)
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{pname}: reference {tuple(t.shape)} "
                                 f"{t.dtype}, port {tuple(p.shape)} "
                                 f"{p.dtype}")
            p.data.copy_(t)
            want.add(pname)
    missing = sorted(set(params) - want)
    if missing:
        raise KeyError(f"parameters absent from the reference tree: "
                       f"{missing}")
    return model
