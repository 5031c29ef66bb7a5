"""Public ops over the radix top-k kernel.

The CUDA kernel computes per-row thresholds (the sortable value of the
k-th largest element) on the card, and in its top-k entry also what the
reference's ``repro/kernels/radix_topk/ops.py`` does around its Pallas
call (one XLA program there): the exact-k mask with the lowest-index tie
rule, the compaction into (value desc, index asc), and the first level
of the two-level bank reduction for rows wider than ``bank_width``
(per-bank top-k candidates, then a manager pass over their union, exact
because the global top-k lies in the union of the bank top-ks).  For
CPU tensors the plain versions of :mod:`.ref` and this module run
instead.

Threshold entries: :func:`threshold_f32` takes float32 values and maps
them to the sortable domain inside the kernel (the reference's
``threshold_pallas``); :func:`threshold_sortable` takes sortable uint32
words (any width).  The library picks the instance by the row's width
N: rows of at most :data:`NARROW_N` words take the narrow instance (a
warp a row, a block a tile of 8 rows), wider ones a block a row,
streamed from device memory past :func:`smem_n` words.  The top-k entry
:func:`fused_topk` fuses the threshold, the mask and the compaction into
one launch of either instance, with the options the call sites need:
the complement (kmin), each row's plane reads, banked rows read in
place, a payload written in place of the indices, and one packed output
buffer.  :func:`radix_topk` takes it at every width: one launch, or two
for a banked row (the banks, then the manager pass with the banks'
indices as its payload).  ``launches`` counts the CUDA launches of every
entry since import or the last :func:`reset_launches`, a fused launch
once; ``instance_launches`` splits them by instance (``narrow``,
``block``, ``streamed``, as :func:`instance` decides; a banked launch is
``block``) and ``entry_launches`` by entry (``threshold``, ``topk``);
:func:`empty_launch` (an empty kernel launched as one tile, the card's
launch floor) is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch._device import resolve_device
from repro_torch.core.bitmatrix import as_words, to_uint32
from repro_torch.core.topk import (
    exact_k_mask,
    from_sortable_uint,
    to_sortable_uint,
)
from repro_torch.kernels import _build

from . import ref as _ref

__all__ = [
    "MAX_N",
    "NARROW_N",
    "compact_sortable",
    "digit_bits",
    "empty_launch",
    "fused_topk",
    "radix_topk",
    "radix_topk_threshold",
    "reset_launches",
    "smem_n",
    "threshold_f32",
    "threshold_sortable",
    "topk_mask_from_threshold",
]

MAX_N = 16384  # widest row of one threshold pass; wider rows are banked
NARROW_N = 1024  # widest row of the narrow instance (radix_narrow_n())
# sortable(-inf): the reference pads banked rows with -inf
_NEG_INF_WORD = 0x007FFFFF
_MASK32 = 0xFFFFFFFF

launches = 0
instance_launches = {"narrow": 0, "block": 0, "streamed": 0}
entry_launches = {"threshold": 0, "topk": 0}


def reset_launches() -> None:
    global launches
    launches = 0
    for counts in (instance_launches, entry_launches):
        for name in counts:
            counts[name] = 0


def instance(n: int, bank: int = 0) -> str:
    """The kernel instance that takes rows of ``n`` words (read as banks
    of ``bank`` words, a block each, when ``bank`` is set)."""
    if bank:
        return "block"
    if n <= NARROW_N:
        return "narrow"
    return "block" if n <= MAX_N else "streamed"


def _lib() -> ctypes.CDLL:
    lib = _build.load("radix_threshold")
    if lib.radix_threshold_launch.argtypes is None:   # first load
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.radix_threshold_launch.argtypes = [vp, vp, vp, i, i, i, i, vp]
        lib.radix_threshold_launch.restype = i
        lib.radix_select_launch.argtypes = [vp] * 5 + [i] * 6 + [vp]
        lib.radix_select_launch.restype = i
        lib.radix_empty_launch.argtypes = [vp]
        lib.radix_empty_launch.restype = i
        for fn in (lib.radix_digit_bits, lib.radix_smem_n,
                   lib.radix_narrow_n):
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


def _check(x: torch.Tensor, k: int, float_in: bool) -> None:
    want = (torch.float32,) if float_in else (torch.uint32, torch.int32)
    if x.dtype not in want:
        raise TypeError(f"radix threshold kernel takes {want}, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("radix threshold kernel takes a contiguous (B, N) "
                         "tensor")
    if not 1 <= k <= x.shape[1]:
        raise ValueError(f"k={k} out of range for N={x.shape[1]}")


def _launched(err: int, entry: str, inst: str) -> None:
    """Raise on a launch error; else count one launch of ``entry`` on the
    instance ``inst``."""
    global launches
    if err != 0:
        raise RuntimeError(f"radix kernel launch failed: CUDA error {err}")
    launches += 1
    entry_launches[entry] += 1
    instance_launches[inst] += 1


def _launch(x: torch.Tensor, k: int, float_in: bool):
    """Launch the threshold entry on ``x`` (B, N) 32-bit words on the
    card."""
    _check(x, k, float_in)
    b, n = x.shape
    thresh = torch.empty((b,), dtype=torch.uint32, device=x.device)
    visited = torch.empty((b,), dtype=torch.int32, device=x.device)
    if b:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().radix_threshold_launch(
                x.data_ptr(), thresh.data_ptr(), visited.data_ptr(), b, n, k,
                int(float_in), stream)
        _launched(err, "threshold", instance(n))
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


def compact_sortable(u: torch.Tensor, mask: torch.Tensor, k: int):
    """Gather the k selected words per row, ordered (value desc, index
    asc): ``(values as int64 carriers, indices int32)``."""
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
    order = torch.argsort(vals_u ^ _MASK32, dim=-1, stable=True)
    vals_u = torch.gather(vals_u, 1, order)
    return vals_u, torch.gather(idxs, 1, order).to(torch.int32)


def _check_select(x, k, complement, bank, payload) -> None:
    float_in = x.dtype == torch.float32
    if bank:
        if not float_in or complement or payload is not None:
            raise ValueError("banked rows take float32 values, with no "
                             "complement and no payload")
        if not 1 <= k <= bank <= MAX_N:
            raise ValueError(f"k={k} and bank={bank} out of range (k <= "
                             f"bank <= {MAX_N})")
        _check(x, 1, float_in)
        return
    _check(x, k, float_in)
    if float_in and x.shape[1] > MAX_N:
        raise ValueError(f"N={x.shape[1]} > MAX_N={MAX_N}: float32 rows "
                         "that wide are banked")
    if complement and float_in:
        raise ValueError("the complement takes sortable words")
    if payload is not None and (payload.dtype != torch.int32
                                or payload.shape != x.shape
                                or not payload.is_contiguous()
                                or payload.device != x.device):
        raise ValueError("payload: a contiguous int32 tensor of x's shape "
                         "on x's device")


def _outputs(x, rows: int, k: int, reads: bool, packed: bool):
    """The entry's outputs: ``(returned, vals, idxs, reads, ld_out)``."""
    dev = x.device
    if packed:
        buf = torch.empty((rows, 2 * k + int(reads)), dtype=torch.int32,
                          device=dev)
        return (buf, buf[:, :k], buf[:, k:2 * k],
                buf[:, 2 * k] if reads else None, 2 * k + int(reads))
    vals = torch.empty((rows, k), dtype=x.dtype, device=dev)
    idxs = torch.empty((rows, k), dtype=torch.int32, device=dev)
    rd = torch.empty((rows,), dtype=torch.int32, device=dev) if reads else None
    return ((vals, idxs) + ((rd,) if reads else ()), vals, idxs, rd, 0)


def fused_topk(x: torch.Tensor, k: int, *, complement: bool = False,
               reads: bool = False, bank: int = 0, payload=None,
               packed: bool = False):
    """The top-k entry, one launch on the card.

    ``x`` (B, N): float32 values (N at most ``MAX_N``) or sortable 32-bit
    words (uint32, or int32 bit patterns; any N) -> each row's k largest
    ``(values of x's type, indices int32)``, ordered (value desc, index
    asc), the lowest indices taken among ties at the k-th value: what the
    reference's ``radix_topk`` computes for such rows.  Options:

    * ``complement`` (sortable words): the k smallest, in ascending order
      (the serving backend's kmin: top-k of the complement);
    * ``reads``: also each row's mixed planes, ``popc(OR ^ AND)`` (int32),
      appended to the outputs;
    * ``bank`` (float32): each row read in place as ``ceil(N / bank)``
      banks of ``bank`` words, the columns past N as -inf: ``(B *
      banks, k)`` outputs, bank after bank, with global indices;
    * ``payload`` (int32, x's shape): ``payload[row, j]`` in place of
      each index j;
    * ``packed``: one int32 ``(rows, 2k [+ 1])`` buffer, the values' bits,
      the indices and the reads.

    The plain version for CPU tensors; on the card a launch error
    raises."""
    _check_select(x, k, complement, bank, payload)
    if x.device.type == "cpu":
        return _plain_topk(x, k, complement=complement, reads=reads,
                           bank=bank, payload=payload, packed=packed)
    b, n = x.shape
    rows = b * (-(-n // bank) if bank else 1)
    out, vals, idxs, rd, ld = _outputs(x, rows, k, reads, packed)
    if b:
        flags = int(x.dtype == torch.float32) | (2 if complement else 0)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _lib().radix_select_launch(
                x.data_ptr(), vals.data_ptr(), idxs.data_ptr(),
                rd.data_ptr() if rd is not None else None,
                payload.data_ptr() if payload is not None else None,
                b, n, k, bank, ld, flags, stream)
        _launched(err, "topk", instance(n, bank))
    return out


def _plain_topk(x: torch.Tensor, k: int, *, complement: bool = False,
                reads: bool = False, bank: int = 0, payload=None,
                packed: bool = False):
    """:func:`fused_topk`'s plain version, on ``x``'s device: the
    threshold of :mod:`.ref`, the exact-k mask and the compaction."""
    _check_select(x, k, complement, bank, payload)
    float_in = x.dtype == torch.float32
    u = to_sortable_uint(x) if float_in else as_words(x)
    b, n = u.shape
    if bank:
        c = -(-n // bank)
        u = torch.nn.functional.pad(u, (0, c * bank - n),
                                    value=_NEG_INF_WORD).reshape(b * c, bank)
    rd = _mixed_planes(u) if reads else None
    if complement:
        u = u ^ _MASK32
    thresh = _ref.threshold_ref(u, k)[0]
    vals_u, idxs = compact_sortable(
        u, exact_k_mask(u, as_words(thresh)[..., None], k), k)
    if complement:
        vals_u = vals_u ^ _MASK32
    if bank:
        first = torch.arange(b * c, device=u.device) % c * bank
        idxs = idxs + first[:, None].to(torch.int32)
    if payload is not None:
        idxs = torch.gather(payload, 1, idxs.to(torch.int64))
    vals = (from_sortable_uint(vals_u, torch.float32) if float_in
            else to_uint32(vals_u).view(x.dtype))
    if packed:
        return torch.cat([vals.view(torch.int32), idxs]
                         + ([rd[:, None]] if reads else []), 1)
    return (vals, idxs) + ((rd,) if reads else ())


def _mixed_planes(u: torch.Tensor) -> torch.Tensor:
    """``popc(OR ^ AND)`` of each row of sortable words, int32."""
    mixed = _ref._or_rows(u) ^ (_MASK32 ^ _ref._or_rows(u ^ _MASK32))
    planes = torch.arange(32, dtype=torch.int64, device=u.device)
    return ((mixed[:, None] >> planes) & 1).sum(-1).to(torch.int32)


def _as_dtype(vals: torch.Tensor, dtype) -> torch.Tensor:
    """float32 top-k values in the input's dtype, as the reference's
    compaction returns them (an integer input through float32)."""
    if dtype == torch.float32:
        return vals
    if dtype.is_floating_point:
        return vals.to(dtype)
    return from_sortable_uint(to_sortable_uint(vals), dtype)


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
    reduction: the banks read in place by one launch, then the manager
    pass over their candidates, which writes the banks' global indices
    itself (its payload)."""
    x = torch.as_tensor(x, device=resolve_device(device))
    orig_shape = x.shape
    if x.device.type == "meta":
        return _meta_topk(x, k)
    n = orig_shape[-1]
    xf = x.reshape(-1, n)
    b = xf.shape[0]
    x32 = xf.to(torch.float32).contiguous()
    if n <= bank_width:
        vals, idxs = fused_topk(x32, k)
    else:
        c = -(-n // bank_width)
        kb = min(k, bank_width)
        # bank candidates are (value desc, index asc) within banks and the
        # banks are in order, so the lowest global index wins a tie
        vb, ib = fused_topk(x32, kb, bank=bank_width)
        vals, idxs = fused_topk(vb.view(b, c * kb), k,
                                payload=ib.view(b, c * kb))
    return (_as_dtype(vals, xf.dtype).reshape(orig_shape[:-1] + (k,)),
            idxs.reshape(orig_shape[:-1] + (k,)))
