"""Multi-bank management over ranks (paper §IV -> collectives).

The port of ``repro/core/distsort.py``.  The multi-bank manager's OR-gates
become collective reductions over a mesh axis: each rank is a "bank"
holding a shard of the trailing axis, its local counts are combined with
``psum``/``pmin`` per bit plane, and every bank then applies the one
globally consistent decision, the circuit's ``en_sync`` broadcast.

Used by gradient compression (a global top-k threshold across
data-parallel ranks).  Every function runs on each rank of the mesh with
that rank's shard and takes the mesh and an axis name (or a tuple of
them), as the reference's take ``axis_name`` inside ``shard_map``
(:mod:`repro_torch.dist._comm`).  Sortable words are carried as
``int64`` (:mod:`repro_torch.core.topk`); the per-plane counts stay on the
device, so the host never waits on them inside the plane loop.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitmatrix import as_words
from repro_torch.dist._comm import all_gather, axis_index, pmin, psum
from .topk import _MASK32, to_sortable_uint

__all__ = ["kth_largest_sharded", "topk_mask_sharded", "global_min_sharded"]


def kth_largest_sharded(u_local: torch.Tensor, k, mesh, axis_name):
    """k-th largest over the concatenation of every bank's trailing axis.

    ``u_local`` is this rank's sortable shard ``(..., N_local)``; ``k`` an
    int or a tensor broadcast against the leading axes.  Returns the global
    k-th largest (int64 carrier), the same on every bank: one ``psum`` of a
    per-row count per bit plane, the multi-bank manager's global
    mixed-column judgement."""
    u = as_words(u_local)
    lead = u.shape[:-1]
    prefix = torch.zeros(lead, dtype=torch.int64, device=u.device)
    need = torch.as_tensor(k, device=u.device).to(torch.int64).expand(lead) \
        .clone()
    for plane in range(31, -1, -1):
        bit = 1 << plane
        hi_mask = _MASK32 ^ ((bit << 1) - 1)           # bits above `plane`
        cand = (u & hi_mask) == prefix[..., None]
        c1 = psum((cand & ((u & bit) != 0)).sum(-1), mesh, axis_name)
        take_hi = c1 >= need
        prefix = torch.where(take_hi, prefix | bit, prefix)
        need = torch.where(take_hi, need, need - c1)
    return prefix


def topk_mask_sharded(x_local: torch.Tensor, k, mesh, axis_name):
    """This rank's boolean mask of the *global* top-k set.

    Ties at the threshold go bank-major, then index-major (bank order =
    axis index), the manager's one-bank-at-a-time output select: exactly k
    elements are selected over all banks."""
    u = to_sortable_uint(x_local)
    t = kth_largest_sharded(u, k, mesh, axis_name)[..., None]
    gt = u > t
    eq = u == t
    # the global tie budget, k - (#global > t), assigned in bank order
    n_gt = psum(gt.sum(-1), mesh, axis_name)
    need_eq = (torch.as_tensor(k, device=u.device) - n_gt)[..., None]
    eq_local = eq.sum(-1)
    bank = axis_index(mesh, axis_name)
    eq_all = all_gather(eq_local, mesh, axis_name)             # (C, ...)
    before = eq_all[:bank].sum(0) if bank else torch.zeros_like(eq_local)
    eq_rank = torch.cumsum(eq.to(torch.int64), -1) - 1 + before[..., None]
    return gt | (eq & (eq_rank < need_eq))


def global_min_sharded(u_local: torch.Tensor, mesh, axis_name):
    """Global min over banks: the paper's single min search, one
    collective."""
    return pmin(as_words(u_local).amin(-1), mesh, axis_name)
