"""Bit-plane radix selection in the sortable-uint32 domain, on torch.

The torch counterpart of :mod:`repro.core.topk`: the plain engine behind
the radix top-k kernel's reference (``kernels/radix_topk/ref.py``) and the
serving radix backend's telemetry.  Sortable words are carried as
``int64`` holding 0..2**32-1 (torch's ``uint32`` has no shifts or
ordering).  All functions work on the trailing axis, batched over the
leading ones.  Tie-break: the lowest index among equal values wins
(``lax.top_k`` semantics, as in the reference).
"""

from __future__ import annotations

import torch

from repro_torch.core.bitmatrix import as_words, to_uint32

__all__ = [
    "discriminating_planes",
    "exact_k_mask",
    "from_sortable_uint",
    "kth_largest_sortable",
    "to_sortable_uint",
    "topk_mask",
]

_MASK32 = 0xFFFFFFFF
_SIGN = 0x80000000


def to_sortable_uint(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map into 0..2**32-1 (``int64`` carrier).

    float: flip all bits of negatives, the sign bit of non-negatives
    (bf16/f16 are cast to float32 first).  int32: offset by 2**31.
    uint32: identity.
    """
    if x.dtype == torch.uint32:
        return as_words(x)
    if x.dtype == torch.int32:
        return as_words(x) ^ _SIGN
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    if x.dtype != torch.float32:
        raise TypeError(f"unsupported dtype {x.dtype}")
    b = as_words(x.contiguous().view(torch.int32))
    return b ^ torch.where(b >> 31 == 1, _MASK32, _SIGN)


def from_sortable_uint(u: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`to_sortable_uint` (returns ``dtype``)."""
    u = as_words(u)
    if dtype == torch.uint32:
        return to_uint32(u)
    if dtype == torch.int32:
        return (u ^ _SIGN).to(torch.int32)
    b = u ^ torch.where(u >> 31 == 1, _SIGN, _MASK32)
    return b.to(torch.int32).view(torch.float32).to(dtype)


def discriminating_planes(u: torch.Tensor) -> torch.Tensor:
    """Per-plane "mixed" judgement over the trailing axis, bool ``(…, 32)``
    ordered MSB (plane 31) first — the skippable all-0/all-1 columns."""
    planes = torch.arange(31, -1, -1, dtype=torch.int64, device=u.device)
    bits = (as_words(u)[..., None, :] >> planes[:, None]) & 1
    return bits.amax(-1) != bits.amin(-1)


def kth_largest_sortable(u: torch.Tensor, k: int) -> torch.Tensor:
    """Sortable value of the k-th largest element, batched: a bit-plane
    descent from the MSB with a count register."""
    n = u.shape[-1]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for N={n}")
    u = as_words(u)
    prefix = torch.zeros(u.shape[:-1], dtype=torch.int64, device=u.device)
    need = torch.full(u.shape[:-1], k, dtype=torch.int64, device=u.device)
    for plane in range(31, -1, -1):
        bit = 1 << plane
        hi_mask = _MASK32 ^ ((bit << 1) - 1)           # bits above `plane`
        cand = (u & hi_mask) == prefix[..., None]
        c1 = (cand & ((u & bit) != 0)).sum(-1)
        take_hi = c1 >= need
        prefix = torch.where(take_hi, prefix | bit, prefix)
        need = torch.where(take_hi, need, need - c1)
    return prefix


def exact_k_mask(u: torch.Tensor, thresh: torch.Tensor, k: int) -> torch.Tensor:
    """Exactly k marked per row: everything strictly above ``thresh`` plus
    the lowest-index ties at it.  ``thresh`` broadcasts against ``u``
    (pass ``t[..., None]`` per row)."""
    u = as_words(u)
    gt = u > thresh
    eq = u == thresh
    need_eq = k - gt.sum(-1, keepdim=True)
    eq_rank = torch.cumsum(eq.to(torch.int64), -1) - 1
    return gt | (eq & (eq_rank < need_eq))


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the top-k elements, lowest-index tie rule."""
    u = to_sortable_uint(x)
    return exact_k_mask(u, kth_largest_sortable(u, k)[..., None], k)
