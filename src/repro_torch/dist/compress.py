"""Error-feedback top-k gradient compression on the multi-bank OR-gate.

The port of ``repro/dist/compress.py``.  A Deep-Gradient-Compression-style
sparsified all-reduce: each rank adds its carried residual to the fresh
gradient, the |value| top-k over the *union of every rank's entries* is
selected against one globally consistent threshold, the selected entries
are ``psum``-reduced, and what was not selected stays behind as the next
round's residual (error feedback).

The global threshold is the paper's §IV search: ranks play the memory
banks, and the k-th-largest search is
:func:`repro_torch.core.distsort.topk_mask_sharded`, one ``psum`` of a
count per bit plane.  A rank whose compensated gradient carries more
energy therefore transmits more coordinates.  As in the reference, the
selected entries travel in a dense ``psum`` (the semantics, not a sparse
wire format).  Every function runs on each rank with its own gradient
and takes the mesh and the axis to reduce over
(:func:`repro_torch.train.loop.make_dp_train_step` is the training
integration).
"""

from __future__ import annotations

import torch

# a module import: core.distsort imports this package's _comm, and so may
# be the import that is running this one
from repro_torch.core import distsort
from repro_torch.dist._comm import axis_size, psum

__all__ = ["ef_topk_psum", "ef_topk_psum_auto", "ef_topk_psum_tree"]


def ef_topk_psum(grad: torch.Tensor, err: torch.Tensor, mesh, *,
                 ratio: float | None = None, k: int | None = None,
                 axis_name="data"):
    """One compressed all-reduce step with error feedback.

    ``grad``: this rank's gradient (the trailing axis is the coordinate
    axis; leading axes are batched independently); ``err``: the residual
    carried from the last round, same shape; ``ratio``: the share of the
    *global* coordinate count (local count x ranks) to select, or ``k``
    an absolute count.  Returns ``(reduced, new_err)``: the ``psum`` of
    every rank's sparsified compensated gradient (divide by the axis size
    for a mean) and this rank's unselected remainder."""
    c = grad + err
    n_global = c.shape[-1] * axis_size(mesh, axis_name)
    if k is None:
        if ratio is None:
            raise ValueError("pass exactly one of ratio= or k=")
        k = int(round(float(ratio) * n_global))
    k = max(1, min(int(k), n_global))
    mask = distsort.topk_mask_sharded(c.abs(), k, mesh, axis_name)
    selected = torch.where(mask, c, torch.zeros_like(c))
    return psum(selected, mesh, axis_name), c - selected


def ef_topk_psum_auto(grad: torch.Tensor, err: torch.Tensor, mesh, *,
                      base_ratio: float, max_ratio: float = 1.0,
                      axis_name="data"):
    """:func:`ef_topk_psum` with a ratio scheduled by gradient energy:

        r = clip(base_ratio * (1 + E_err / E_grad), base_ratio, max_ratio)

    with both energies global (one ``psum`` of the stacked pair), so every
    rank schedules the same ratio; with leading batch axes the schedule is
    per batch.  ``k`` is a tensor on the device (the §IV search takes a
    dynamic count).  At ``base_ratio=1.0`` selection is total: reduced /
    ranks is the ``pmean`` and the residual is zero.  Returns ``(reduced,
    new_err, ratio_used)``."""
    if not 0.0 < base_ratio <= max_ratio <= 1.0:
        raise ValueError(f"need 0 < base_ratio <= max_ratio <= 1, got "
                         f"{base_ratio}/{max_ratio}")
    c = grad + err
    n_global = c.shape[-1] * axis_size(mesh, axis_name)
    e = psum(torch.stack([(grad * grad).sum(-1), (err * err).sum(-1)]),
             mesh, axis_name)
    boost = e[1] / torch.clamp(e[0], min=torch.finfo(e.dtype).tiny)
    r = torch.clamp(base_ratio * (1.0 + boost), base_ratio, max_ratio)
    k = torch.clamp(torch.round(r * n_global).to(torch.int32), 1, n_global)
    mask = distsort.topk_mask_sharded(c.abs(), k, mesh, axis_name)
    selected = torch.where(mask, c, torch.zeros_like(c))
    return psum(selected, mesh, axis_name), c - selected, r


def ef_topk_psum_tree(grads, errs, mesh, *, ratio: float, axis_name="data"):
    """Per-leaf :func:`ef_topk_psum` over matching nested dicts (each leaf
    flattened).  Each leaf accumulates in its residual's dtype (float32):
    a bf16 residual would round away the small entries error feedback
    exists to keep.  Returns ``(reduced_tree, new_err_tree)``."""
    if isinstance(grads, dict) != isinstance(errs, dict) or (
            isinstance(grads, dict) and set(grads) != set(errs)):
        raise ValueError("grads and errs must have matching structure")
    if not isinstance(grads, dict):
        r, ne = ef_topk_psum(grads.reshape(-1).to(errs.dtype),
                             errs.reshape(-1), mesh, ratio=ratio,
                             axis_name=axis_name)
        return r.reshape(grads.shape).to(grads.dtype), ne.reshape(grads.shape)
    red, err = {}, {}
    for key in grads:
        red[key], err[key] = ef_topk_psum_tree(grads[key], errs[key], mesh,
                                               ratio=ratio,
                                               axis_name=axis_name)
    return red, err
