"""Public ops over the radix top-k threshold kernel.

The CUDA kernel computes per-row thresholds (the sortable value of the
k-th largest element) on the card; for CPU tensors the plain version of
:mod:`.ref` runs instead.  Around it, in plain torch as in the reference's
``repro/kernels/radix_topk/ops.py``: the exact-k mask with the
lowest-index tie rule, the compaction into (value desc, index asc), and
the two-level bank reduction for rows wider than ``bank_width`` (per-bank
top-k candidates, then a manager pass over their union — exact, because
the global top-k lies in the union of the bank top-ks).

Two kernel entries: :func:`threshold_f32` takes float32 values and maps
them to the sortable domain inside the kernel (the reference's
``threshold_pallas``); :func:`threshold_sortable` takes sortable uint32
words (the serving radix backend's tiles), of any width: rows wider than
the kernel's shared memory (:func:`smem_n` words) take its streamed
instance.  ``launches`` counts the CUDA launches of either since import
or the last :func:`reset_launches`; :func:`empty_launch` (an empty kernel
launched as one tile, the card's launch floor) is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch._device import resolve_device
from repro_torch.core.bitmatrix import as_words
from repro_torch.core.topk import (
    exact_k_mask,
    from_sortable_uint,
    to_sortable_uint,
)
from repro_torch.kernels import _build

from . import ref as _ref

__all__ = [
    "MAX_N",
    "compact_sortable",
    "compact_topk",
    "digit_bits",
    "empty_launch",
    "radix_topk",
    "radix_topk_threshold",
    "reset_launches",
    "smem_n",
    "threshold_f32",
    "threshold_sortable",
    "topk_mask_from_threshold",
]

MAX_N = 16384  # widest row of one threshold pass; wider rows are banked

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("radix_threshold")
    if lib.radix_threshold_launch.argtypes is None:   # first load
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.radix_threshold_launch.argtypes = [vp, vp, vp, i, i, i, i, vp]
        lib.radix_threshold_launch.restype = i
        lib.radix_empty_launch.argtypes = [vp]
        lib.radix_empty_launch.restype = i
        for fn in (lib.radix_digit_bits, lib.radix_smem_n):
            fn.argtypes = []
            fn.restype = i
    return lib


def digit_bits() -> int:
    """Planes the CUDA kernel's digit descent resolves a pass."""
    return _lib().radix_digit_bits()


def smem_n() -> int:
    """Widest row the CUDA kernel holds in shared memory; wider rows (the
    sortable entry only) stream from device memory on every pass."""
    return _lib().radix_smem_n()


def empty_launch(device="cuda") -> None:
    """Launch an empty kernel shaped as one tile of the threshold kernel
    (no CPU version: it measures the card).  Time it to read the card's
    launch floor."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("empty_launch measures the card; it has no CPU "
                         "version")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().radix_empty_launch(stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def _launch(x: torch.Tensor, k: int, float_in: bool):
    """Launch the CUDA kernel on ``x`` (B, N) 32-bit words on the card."""
    global launches
    want = (torch.float32,) if float_in else (torch.uint32, torch.int32)
    if x.dtype not in want:
        raise TypeError(f"radix threshold kernel takes {want}, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("radix threshold kernel takes a contiguous (B, N) "
                         "tensor")
    b, n = x.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} out of range for N={n}")
    dev = x.device
    thresh = torch.empty((b,), dtype=torch.uint32, device=dev)
    visited = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return thresh, visited
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.radix_threshold_launch(x.data_ptr(), thresh.data_ptr(),
                                         visited.data_ptr(), b, n, k,
                                         int(float_in), stream)
    if err != 0:
        raise RuntimeError(f"radix threshold kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return thresh, visited


def threshold_f32(x: torch.Tensor, k: int):
    """``(B, N<=MAX_N)`` float32 -> ``(thresh (B,) uint32, visited (B,)
    int32)``: the port of ``threshold_pallas``, tile-level ``visited``."""
    if x.shape[-1] > MAX_N:
        raise ValueError(f"N={x.shape[-1]} > MAX_N={MAX_N}; bank at the ops "
                         "level")
    if x.device.type == "cpu":
        return _ref.threshold_ref(to_sortable_uint(x), k)
    return _launch(x.contiguous(), k, float_in=True)


def threshold_sortable(u, k: int, *, device="cuda"):
    """``(B, N)`` sortable uint32 words -> ``(thresh, visited)``, the same
    descent without the float mapping (any N)."""
    u = torch.as_tensor(u, device=resolve_device(device))
    if u.device.type == "cpu":
        return _ref.threshold_ref(u, k)
    return _launch(u.contiguous(), k, float_in=False)


def radix_topk_threshold(x, k: int, *, device="cuda") -> torch.Tensor:
    """Sortable-uint32 threshold (k-th largest) per row of ``x`` (B, N)."""
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.device.type == "meta":
        return torch.empty(x.shape[:-1], dtype=torch.uint32, device="meta")
    return threshold_f32(x.to(torch.float32), k)[0]


def topk_mask_from_threshold(x: torch.Tensor, thresh: torch.Tensor,
                             k: int) -> torch.Tensor:
    """Exact-k boolean mask from a per-row threshold; low-index tie-break."""
    u = to_sortable_uint(x.to(torch.float32))
    return exact_k_mask(u, as_words(thresh)[..., None], k)


def compact_topk(x: torch.Tensor, u: torch.Tensor, mask: torch.Tensor,
                 k: int):
    """Gather the k selected entries per row, ordered (value desc, index
    asc); values come back in ``x``'s dtype, indices as int32."""
    vals_u, idxs = compact_sortable(u, mask, k)
    return from_sortable_uint(vals_u, x.dtype), idxs


def compact_sortable(u: torch.Tensor, mask: torch.Tensor, k: int):
    """:func:`compact_topk` in the sortable domain: ``(values as int64
    carriers, indices int32)``."""
    b, n = u.shape
    dev = u.device
    slot = torch.cumsum(mask.to(torch.int64), -1) - 1
    slot = torch.where(mask, slot, k)                  # k -> dropped
    cols = torch.arange(n, device=dev).expand(b, n)
    vals_u = torch.zeros((b, k + 1), dtype=torch.int64, device=dev).scatter_(
        1, slot, as_words(u).expand(b, n))[:, :k]
    idxs = torch.zeros((b, k + 1), dtype=torch.int64, device=dev).scatter_(
        1, slot, cols)[:, :k]
    # slots are index-ascending, so a stable sort on the inverted value
    # alone keeps the tie order
    order = torch.argsort(vals_u ^ 0xFFFFFFFF, dim=-1, stable=True)
    vals_u = torch.gather(vals_u, 1, order)
    return vals_u, torch.gather(idxs, 1, order).to(torch.int32)


def _topk_rows(xf: torch.Tensor, k: int):
    thresh = threshold_f32(xf.to(torch.float32), k)[0]
    mask = topk_mask_from_threshold(xf, thresh, k)
    return compact_topk(xf, to_sortable_uint(xf.to(torch.float32)), mask, k)


def _meta_topk(x: torch.Tensor, k: int):
    """``radix_topk``'s outputs for a ``meta`` input: shapes and dtypes
    only.  ``meta`` holds no values and runs nothing (the dry-run traces
    a step there), so this is no stand-in for the kernel: a ``cuda`` or
    ``cpu`` input never comes here."""
    shape = x.shape[:-1] + (k,)
    return (torch.empty(shape, dtype=x.dtype, device="meta"),
            torch.empty(shape, dtype=torch.int32, device="meta"))


def radix_topk(x, k: int, *, bank_width: int = MAX_N, device="cuda"):
    """Top-k ``(values, indices)`` over the trailing axis, ``lax.top_k``
    semantics; rows wider than ``bank_width`` take the two-level bank
    reduction."""
    x = torch.as_tensor(x, device=resolve_device(device))
    orig_shape = x.shape
    if x.device.type == "meta":
        return _meta_topk(x, k)
    n = orig_shape[-1]
    xf = x.reshape(-1, n)
    b = xf.shape[0]
    if n <= bank_width:
        vals, idxs = _topk_rows(xf, k)
    else:
        c = -(-n // bank_width)
        fill = (float("-inf") if xf.dtype.is_floating_point
                else torch.iinfo(xf.dtype).min)
        xp = torch.nn.functional.pad(xf, (0, c * bank_width - n), value=fill)
        xb = xp.reshape(b * c, bank_width)
        kb = min(k, bank_width)
        vb, ib = _topk_rows(xb, kb)
        bank_of = (torch.arange(b * c, device=x.device) % c)[:, None]
        gidx = ib.to(torch.int64) + bank_of * bank_width
        cand_v = vb.reshape(b, c * kb)
        cand_i = gidx.reshape(b, c * kb)
        # bank candidates are (value desc, index asc) within banks and the
        # banks are in order, so the lowest global index wins a tie
        vals, slots = _topk_rows(cand_v, k)
        idxs = torch.gather(cand_i, 1, slots.to(torch.int64)).to(torch.int32)
    return (vals.reshape(orig_shape[:-1] + (k,)),
            idxs.reshape(orig_shape[:-1] + (k,)))
