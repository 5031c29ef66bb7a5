"""The single-row column-skipping sort, the counterpart of
:func:`repro.core.jaxsort.colskip_sort_jax`.

The reference keeps a jitted single-row machine beside the batched Pallas
kernel; the port has one batched machine (the colskip kernel on the card,
its plain torch version on the CPU, :mod:`repro_torch.kernels.colskip`),
so the single-row form is a one-row call of it.  The file keeps the
reference's name so that a reader finds the counterpart.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.colskip.ops import colskip_sort_batched

__all__ = ["colskip_sort_torch"]


def colskip_sort_torch(values, w: int = 32, k: int = 2,
                       stop_after: int | None = None, packed: bool = True,
                       device="cuda"):
    """Sort ``values`` ((N,) 32-bit words) ascending with the §III machine.

    Returns ``(sorted_values (stop,) uint32, order (stop,) int32,
    column_reads, cycles)``, the last two 0-dim int32 tensors, as
    ``colskip_sort_jax`` does.  ``stop_after`` and ``packed`` mean what
    they mean there; ``device`` picks the kernel (``cuda``) or the plain
    machine (``cpu``)."""
    v = torch.as_tensor(values, device=resolve_device(device))
    if v.dim() != 1:
        raise ValueError(f"expected one row (N,), got {tuple(v.shape)}")
    vals, order, crs, cyc = colskip_sort_batched(
        v[None, :], w, k, stop_after=stop_after, packed=packed,
        device=device)
    return vals[0], order[0], crs[0], cyc[0]
