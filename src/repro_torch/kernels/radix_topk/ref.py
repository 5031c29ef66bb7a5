"""Plain torch version of the radix top-k threshold kernel.

It computes what ``repro/kernels/radix_topk/kernel.py:_threshold_kernel``
computes, tile by tile: per row the sortable value of the k-th largest
element, and per TB-row tile the number of planes visited after the
leading planes uniform in every row of the tile are skipped.  Rows past
``B`` in the last tile count as constant rows (the kernel's ``-inf``
padding).  Words are ``int64`` carriers holding 0..2**32-1.  The tests
hold it against the Pallas kernel in interpret mode; the wrapper in
``ops.py`` takes it for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitmatrix import as_words, to_uint32

DEFAULT_TB = 8
_MASK32 = 0xFFFFFFFF


def _or_rows(u: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over the trailing axis of 32-bit words."""
    bits = 1 << torch.arange(32, dtype=torch.int64, device=u.device)
    seen = ((u[..., None, :] & bits[:, None]) != 0).any(-1)
    return (seen.to(torch.int64) * bits).sum(-1)


def threshold_ref(u: torch.Tensor, k: int, tb: int = DEFAULT_TB):
    """``(B, N)`` sortable words -> ``(thresh (B,) uint32, visited (B,)
    int32)``, with the tile-level plane skip of the kernel."""
    b, n = u.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for N={n}")
    u = as_words(u)
    dev = u.device
    u_or = _or_rows(u)
    u_and = _MASK32 ^ _or_rows(u ^ _MASK32)
    mixed = u_or ^ u_and
    bp = -(-b // tb) * tb
    mixed = torch.cat([mixed, mixed.new_zeros(bp - b)]).reshape(-1, tb)
    tile_mixed = _or_rows(mixed)                       # (tiles,)
    planes = torch.arange(32, dtype=torch.int64, device=dev)
    has = ((tile_mixed[:, None] >> planes) & 1) > 0
    s_top = torch.where(has, planes, -1).amax(-1)
    s_top = s_top.repeat_interleave(tb)[:b]            # per row
    top = s_top.clamp(0, 30)
    hi0 = torch.where(s_top >= 31, 0,
                      torch.where(s_top < 0, _MASK32,
                                  _MASK32 ^ ((2 << top) - 1)))
    prefix = u_and & hi0
    need = torch.full((b,), k, dtype=torch.int64, device=dev)
    for j in range(32):
        plane = s_top - j
        active = plane >= 0
        bit = 1 << plane.clamp(min=0)
        hi_mask = _MASK32 ^ ((bit << 1) - 1)
        cand = (u & hi_mask[:, None]) == prefix[:, None]
        c1 = (cand & ((u & bit[:, None]) != 0)).sum(-1)
        take = active & (c1 >= need)
        prefix = torch.where(take, prefix | bit, prefix)
        need = torch.where(active & ~take, need - c1, need)
    visited = (s_top + 1).clamp(min=0)
    return to_uint32(prefix), visited.to(torch.int32)
