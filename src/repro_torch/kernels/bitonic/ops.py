"""Public op over the bitonic kernel: CUDA kernel on the card, the plain
network (:mod:`.ref`) for CPU tensors.

``launches`` counts the calls of :func:`bitonic_sort` that launched the
CUDA kernel since import or the last :func:`reset_launches` (one per call;
a row wider than one thread-block cluster takes several launches inside
that call).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import _build

from . import ref as _ref

__all__ = ["bitonic_sort", "reset_launches"]

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("bitonic")
    if lib.bitonic_sort_launch.argtypes is None:      # first load
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.bitonic_sort_launch.argtypes = [vp, vp, i, i, vp]
        lib.bitonic_sort_launch.restype = i
        lib.bitonic_max_n.argtypes = []
        lib.bitonic_max_n.restype = i
    return lib


def _launch(x: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on ``x`` (B, N) 32-bit words on the card."""
    global launches
    if x.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"bitonic kernel takes 32-bit words, got {x.dtype}")
    b, n = x.shape
    lib = _lib()
    if n > lib.bitonic_max_n():
        raise ValueError(f"N={n} > {lib.bitonic_max_n()}, the widest row the "
                         "CUDA kernel takes")
    out = torch.empty((b, n), dtype=torch.uint32, device=x.device)
    if b == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bitonic_sort_launch(x.data_ptr(), out.data_ptr(), b, n,
                                      stream)
    if err != 0:
        raise RuntimeError(f"bitonic kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def bitonic_sort(x, *, device="cuda") -> torch.Tensor:
    """Ascending sort of each row of ``x`` (B, N) 32-bit words with the
    bitonic network; returns ``(B, N)`` uint32.  N must be a power of two
    (``ValueError`` otherwise; N=1 makes no pass).  ``x`` (a tensor or
    array) is moved to ``device``: on the card the CUDA kernel runs, on the
    CPU the plain network of :mod:`.ref`."""
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.dim() != 2:
        raise ValueError(f"expected (B, N) rows, got {tuple(x.shape)}")
    _ref.check_width(x.shape[1])
    if x.device.type == "cpu":
        return _ref.sort_ref(x)
    return _launch(x.contiguous())
