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
:func:`granite_from_hf` builds granite's published model from HF
``GraniteMoeForCausalLM`` tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg
from .api import model_class

# the reference's stacked subtrees -> the port's ModuleLists
STACKED = {"layers": "blocks", "enc_layers": "enc_blocks",
           "dec_layers": "dec_blocks"}


_PORT_TO_REF = {v: k for k, v in STACKED.items()}

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


def ref_path(name: str) -> tuple:
    """A port parameter name as ``(the reference's dotted path, layer)``:
    ``blocks.3.attn.wq`` -> ``("layers.attn.wq", 3)``; a leaf outside the
    stacked subtrees has layer None."""
    top, _, rest = name.partition(".")
    if top in _PORT_TO_REF:
        i, _, rest = rest.partition(".")
        return f"{_PORT_TO_REF[top]}.{rest}", int(i)
    return name, None


def stack_layers(named) -> dict:
    """``{reference path: tensor}``: the tensors of ``named`` (parameter
    names -> tensors, e.g. a step's grads) as the reference's leaves, each
    stacked subtree's layers on a new leading L axis (a copy)."""
    out, layers = {}, {}
    for name, t in named.items():
        path, i = ref_path(name)
        if i is None:
            out[path] = t
        else:
            layers.setdefault(path, {})[i] = t
    for path, ts in layers.items():
        out[path] = torch.stack([ts[i] for i in range(len(ts))])
    return out


def unstack_layers(stacked: dict, names) -> dict:
    """The inverse of :func:`stack_layers` for the parameter ``names``:
    ``{name: its slice of the reference leaf}`` (views)."""
    out = {}
    for name in names:
        path, i = ref_path(name)
        out[name] = stacked[path] if i is None else stacked[path][i]
    return out


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


# ------------------------------------------------- HF GraniteMoe checkpoints

def _granite_leaf(name: str):
    """The port's parameter of HF ``GraniteMoeForCausalLM`` parameter
    ``name`` -> (the port's dotted name, how its tensor maps: ``"T"``
    transposed, ``"T12"`` with its last two axes swapped, ``"norm"``
    ``weight - 1``, ``"pad"`` the embedding's padded rows added)."""
    if name == "model.embed_tokens.weight":
        return "embed", "pad"
    if name == "model.norm.weight":
        return "final_norm.scale", "norm"
    parts = name.split(".")
    i, rest = int(parts[2]), ".".join(parts[3:])
    port = {"input_layernorm.weight": ("ln1.scale", "norm"),
            "post_attention_layernorm.weight": ("ln2.scale", "norm"),
            "self_attn.q_proj.weight": ("attn.wq", "T"),
            "self_attn.k_proj.weight": ("attn.wk", "T"),
            "self_attn.v_proj.weight": ("attn.wv", "T"),
            "self_attn.o_proj.weight": ("attn.wo", "T"),
            "block_sparse_moe.router.layer.weight": ("moe.router", "T"),
            "block_sparse_moe.input_linear.weight": ("moe.gate_up", "T12"),
            "block_sparse_moe.output_linear.weight": ("moe.down", "T12")}
    leaf, how = port[rest]
    return f"blocks.{i}.{leaf}", how


@torch.no_grad()
def granite_from_hf(cfg: ModelCfg, named, *, device="cuda"):
    """A granite dropless model (:class:`~repro_torch.configs
    .granite_3_0_3b_a800m.GraniteCfg`) from HF ``GraniteMoeForCausalLM``
    tensors, ``named`` an iterable of ``(name, tensor)`` taken one at a
    time (each freed once copied in): ``(out, in)`` projections become the
    port's ``(in, out)``, the experts' ``(E, out, in)`` ``(E, in, out)``,
    RMSNorm weights the port's ``weight - 1`` (computed in float32), the
    embedding gains the padded vocabulary's zero rows; each is cast to the
    parameter's dtype (the router stays float32).  Every parameter must
    be given."""
    model = model_class(cfg)(cfg, device=device, generator=None)
    params = dict(model.named_parameters())
    missing = set(params)
    for name, t in named:
        port, how = _granite_leaf(name)
        p = params[port]
        t = t.to(device=p.device, dtype=torch.float32)
        if how == "T":
            t = t.T
        elif how == "T12":
            t = t.transpose(1, 2)
        elif how == "norm":
            t = t - 1.0
        elif how == "pad":
            p[t.shape[0]:].zero_()
            p = p[:t.shape[0]]
        if p.shape != t.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not fit "
                             f"{port} {tuple(p.shape)}")
        p.copy_(t)
        missing.discard(port)
    if missing:
        raise ValueError(f"no tensor given for {sorted(missing)}")
    return model
