"""Plain torch version of the bitonic kernel: the same network.

It mirrors ``_bitonic_kernel`` (``repro/kernels/bitonic/kernel.py:29-50``):
stage ``k`` doubles the sorted-run length, substage ``j`` exchanges lane
``i`` with lane ``i ^ j``, ascending where ``i & k == 0``, written as a
reshape to ``(B, N/2j, 2, j)`` and an elementwise min/max.  It is the
network itself, not a library sort.  Words travel as ``int64`` carriers:
torch's ``uint32`` has no minimum or maximum.  The tests hold it against
the Pallas kernel in interpret mode; the wrapper in ``ops.py`` takes it
for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel against it
on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.bitmatrix import as_words, to_uint32

__all__ = ["check_width", "n_passes", "sort_ref"]


def n_passes(n: int) -> int:
    """Compare-exchange passes = log2(N)(log2(N)+1)/2 (the latency model)."""
    ln = n.bit_length() - 1
    return ln * (ln + 1) // 2


def check_width(n: int) -> None:
    """Raise unless ``n`` is a power of two (the network's only width)."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"bitonic needs power-of-two N, got {n}")


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    """``(B, N)`` 32-bit words (uint32, int32 bit patterns or an int64
    carrier) -> ``(B, N)`` uint32, each row ascending."""
    b, n = x.shape
    check_width(n)
    u = as_words(x)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            # lane i = q*2j + s*j + t pairs with i^j: axis 2 below is s
            m = n // (2 * j)
            v = u.reshape(b, m, 2, j)
            lo_in, hi_in = v[:, :, 0, :], v[:, :, 1, :]
            mn, mx = torch.minimum(lo_in, hi_in), torch.maximum(lo_in, hi_in)
            # direction bit: k >= 2j, so i & k depends only on the block q
            q = torch.arange(m, device=x.device)[None, :, None]
            up = (q * (2 * j)) & k == 0
            u = torch.stack([torch.where(up, mn, mx), torch.where(up, mx, mn)],
                            dim=2).reshape(b, n)
            j //= 2
        k *= 2
    return to_uint32(u)
