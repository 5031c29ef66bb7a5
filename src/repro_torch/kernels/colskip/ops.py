"""Public op over the colskip sort kernel: CUDA kernel on the card, the
plain torch machine (:mod:`.ref`) for CPU tensors.

``launches`` counts the CUDA kernel launches made through
:func:`colskip_sort_batched` since import or the last :func:`reset_launches`
(``chip_smoke.py`` reads it to show the serving path went through the
kernel).  :func:`vote_chain` runs the latency probe that prices one step
of a row's chain (not counted: it is not the sort kernel).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import _build

from . import ref as _ref

__all__ = ["colskip_sort_batched", "reset_launches", "vote_chain"]

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("colskip")
    if lib.colskip_sort_launch.argtypes is None:      # first load
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.colskip_sort_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, i,
                                            i, vp]
        lib.colskip_sort_launch.restype = i
        lib.colskip_max_n.restype = i
        lib.colskip_max_k.restype = i
        lib.colskip_vote_chain_launch.argtypes = [vp, ctypes.c_uint, i, vp]
        lib.colskip_vote_chain_launch.restype = i
    return lib


def vote_chain(rounds: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """Launch one warp running ``rounds`` dependent warp votes on the card
    (no CPU version: it measures the card); returns its (1,) int32 count
    of true votes.  Time it to price one step of the sort kernel's chain."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("vote_chain measures the card; it has no CPU version")
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().colskip_vote_chain_launch(out.data_ptr(), seed, rounds,
                                               stream)
    if err != 0:
        raise RuntimeError(f"vote chain launch failed: CUDA error {err}")
    return out


def _launch(x: torch.Tensor, w: int, k: int, stop: int):
    """Launch the CUDA kernel on ``x`` (B, N) 32-bit words on the card."""
    global launches
    if x.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"colskip kernel takes 32-bit words, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("colskip kernel takes a contiguous (B, N) tensor")
    b, n = x.shape
    lib = _lib()
    if not 1 <= w <= 32:
        raise ValueError(f"w={w} out of range [1, 32]")
    if not 0 <= k <= lib.colskip_max_k():
        raise ValueError(f"k={k} out of range [0, {lib.colskip_max_k()}] "
                         "for the CUDA kernel")
    if n > lib.colskip_max_n():
        raise ValueError(f"N={n} > {lib.colskip_max_n()}, the widest row the "
                         "CUDA kernel holds")
    dev = x.device
    vals = torch.empty((b, stop), dtype=torch.uint32, device=dev)
    order = torch.empty((b, stop), dtype=torch.int32, device=dev)
    crs = torch.empty((b,), dtype=torch.int32, device=dev)
    cyc = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, order, crs, cyc
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.colskip_sort_launch(
            x.data_ptr(), vals.data_ptr(), order.data_ptr(), crs.data_ptr(),
            cyc.data_ptr(), b, n, w, k, stop, stream)
    if err != 0:
        raise RuntimeError(f"colskip kernel launch failed: CUDA error {err}")
    launches += 1
    return vals, order, crs, cyc


def colskip_sort_batched(x, w: int = 32, k: int = 2, *,
                         stop_after: int | None = None, packed: bool = True,
                         device="cuda"):
    """Sort rows of ``x`` (B, N) 32-bit words ascending with the §III
    machine; returns ``(values, order, column_reads, cycles)``.

    ``values`` (B, stop) uint32, ``order`` (B, stop) int32, per-row CRs and
    cycles (B,) int32, as the reference's ``colskip_sort_batched``.
    ``stop_after=k'`` runs the k-early-exit drain (outputs (B, k')).  ``x``
    (a tensor or array) is moved to ``device``: on the card the CUDA kernel
    runs, on the CPU the plain machine of :mod:`.ref`.
    """
    if not packed:
        raise NotImplementedError(
            "the dense machine (packed=False) is not ported yet "
            "(ROADMAP Queue 1)")
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    b, n = x.shape
    stop = n if stop_after is None else min(int(stop_after), n)
    if stop < 1:
        raise ValueError(f"stop_after={stop_after} must be >= 1")
    if dev.type == "cpu":
        return _ref.sort_ref(x, w, k, stop)
    return _launch(x.contiguous(), w, k, stop)
