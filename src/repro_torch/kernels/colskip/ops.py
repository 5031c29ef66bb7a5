"""Public op over the colskip sort kernel: CUDA kernel on the card, the
plain torch machine (:mod:`.ref`) for CPU tensors.

Two mask carriers, as in the reference: ``packed=True`` (the lane-packed
hot path) and ``packed=False`` (the dense machine).  Each has its own
CUDA kernel behind one C entry point.  :func:`colskip_sort_mesh_batched`
runs the §IV mesh: each row split over 1 to 8 banks, on the card the
mesh kernel (``csrc/colskip_mesh.cu``: a thread-block cluster a row, a
CTA a bank), on the CPU the plain mesh of :mod:`.ref`.  ``launches``
counts the packed kernel's launches made through
:func:`colskip_sort_batched`, ``launches_dense`` the dense kernel's and
``launches_mesh`` the mesh kernel's, since import or the last
:func:`reset_launches` (``chip_smoke.py`` reads them to show a path went
through the kernels), ``launches_mesh_dense`` the dense carrier's mesh
kernel's.  :func:`vote_chain`, :func:`redux_chain` and
:func:`mesh_chain` run the latency probes that price one dependent warp
round of a row's chain and one cross-bank round of a mesh row's (on each
round of ``csrc/mesh_exchange.cuh``, :data:`MESH_ROUNDS_BUILT`); they are
not counted (they are not the kernels a path runs).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import _build

from . import ref as _ref

__all__ = ["MESH_FUSES", "MESH_ROUNDS_BUILT", "colskip_sort_batched",
           "colskip_sort_mesh_batched", "fuse", "max_n", "mesh_chain",
           "mesh_shard_max", "redux_chain", "reset_launches", "vote_chain"]

launches = 0
launches_dense = 0
launches_mesh = 0
launches_mesh_dense = 0

# planes a round the mesh kernel is built for (colskip_mesh.cu), the
# reference's range
MESH_FUSES = (1, 2, 3, 4, 5, 6, 7, 8)
# the cross-bank rounds of csrc/mesh_exchange.cuh, in the C interface's
# numbering: a cluster barrier then a DSMEM read; a push by st.async that
# completes its bytes on the receiver's mbarrier (the mesh kernels' round)
MESH_ROUNDS_BUILT = ("barrier", "async")


def reset_launches() -> None:
    global launches, launches_dense, launches_mesh, launches_mesh_dense
    launches = launches_dense = launches_mesh = launches_mesh_dense = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("colskip")
    if lib.colskip_sort_launch.argtypes is None:      # first load
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.colskip_sort_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, i,
                                            i, i, vp]
        lib.colskip_sort_launch.restype = i
        lib.colskip_max_n.argtypes = [i, i]
        lib.colskip_max_n.restype = i
        lib.colskip_max_k.argtypes = []
        lib.colskip_max_k.restype = i
        lib.colskip_fuse.argtypes = []
        lib.colskip_fuse.restype = i
        lib.colskip_chain_launch.argtypes = [vp, ctypes.c_uint, i, i, vp]
        lib.colskip_chain_launch.restype = i
    return lib


def _mesh_lib() -> ctypes.CDLL:
    lib = _build.load("colskip_mesh")
    if lib.colskip_mesh_launch.argtypes is None:      # first load
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.colskip_mesh_launch.argtypes = [vp] * 6 + [i] * 8 + [vp]
        lib.colskip_mesh_launch.restype = i
        lib.colskip_mesh_chain_launch.argtypes = [vp, ctypes.c_uint, i, i, i,
                                                  vp]
        lib.colskip_mesh_chain_launch.restype = i
        for name in ("colskip_mesh_max_banks", "colskip_mesh_max_k"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.colskip_mesh_shard_max.argtypes = [i, i]
        lib.colskip_mesh_shard_max.restype = i
        lib.colskip_mesh_fuse_built.argtypes = [i]
        lib.colskip_mesh_fuse_built.restype = i
    return lib


def _chain(rounds: int, seed: int, device, redux: bool) -> torch.Tensor:
    dev = resolve_device(device)
    name = "redux_chain" if redux else "vote_chain"
    if dev.type != "cuda":
        raise ValueError(f"{name} measures the card; it has no CPU version")
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().colskip_chain_launch(out.data_ptr(), seed, rounds,
                                          int(redux), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def vote_chain(rounds: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """Launch one warp running ``rounds`` dependent ``__any_sync`` votes on
    the card (no CPU version: it measures the card); returns its (1,) int32
    count of true votes.  Time it to price one dependent warp round."""
    return _chain(rounds, seed, device, redux=False)


def redux_chain(rounds: int, seed: int = 0, device="cuda") -> torch.Tensor:
    """:func:`vote_chain` with ``__reduce_or_sync`` rounds, the reduction
    the packed kernel's fused verdicts and loads take."""
    return _chain(rounds, seed, device, redux=True)


def mesh_chain(rounds: int, banks: int, round: str, seed: int = 0,
               device="cuda") -> torch.Tensor:
    """Launch one cluster of ``banks`` CTAs running ``rounds`` dependent
    cross-bank exchanges on the card (no CPU version), on ``round`` (one of
    :data:`MESH_ROUNDS_BUILT`; the mesh kernels take ``"async"``); returns
    its (1,) int32 count of true words.  Time it to price one round of a
    mesh row's chain."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("mesh_chain measures the card; it has no CPU version")
    if round not in MESH_ROUNDS_BUILT:
        raise ValueError(f"round={round!r}: one of {MESH_ROUNDS_BUILT}")
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _mesh_lib().colskip_mesh_chain_launch(
            out.data_ptr(), seed, rounds, banks,
            MESH_ROUNDS_BUILT.index(round), stream)
    if err != 0:
        raise RuntimeError(f"mesh_chain launch failed: CUDA error {err}")
    return out


def mesh_shard_max(packed: bool, k: int) -> int:
    """Widest shard one bank of the carrier's mesh kernel holds at state
    depth ``k`` on the current card (a row holds banks times that)."""
    return _mesh_lib().colskip_mesh_shard_max(int(packed), k)


def fuse() -> int:
    """Planes the packed CUDA kernel resolves per verdict round."""
    return _lib().colskip_fuse()


def max_n(packed: bool, k: int) -> int:
    """Widest row the carrier's CUDA kernel holds at state depth ``k`` on
    the current card (the dense carrier's shared memory grows with k)."""
    return _lib().colskip_max_n(int(packed), k)


def _launch(x: torch.Tensor, w: int, k: int, stop: int, packed: bool):
    """Launch the carrier's CUDA kernel on ``x`` (B, N) 32-bit words on the
    card."""
    global launches, launches_dense
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
    dev = x.device
    with torch.cuda.device(dev):
        widest = lib.colskip_max_n(int(packed), k)
    if n > widest:
        carrier = "packed" if packed else "dense"
        raise ValueError(f"N={n} > {widest}, the widest row the {carrier} "
                         f"CUDA kernel holds at k={k}")
    vals = torch.empty((b, stop), dtype=torch.uint32, device=dev)
    order = torch.empty((b, stop), dtype=torch.int32, device=dev)
    crs = torch.empty((b,), dtype=torch.int32, device=dev)
    cyc = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, order, crs, cyc
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (x.data_ptr(), vals.data_ptr(), order.data_ptr(),
                crs.data_ptr(), cyc.data_ptr(), b, n, w, k, stop)
        err = lib.colskip_sort_launch(*ptrs, int(packed), stream)
    if err != 0:
        raise RuntimeError(f"colskip kernel launch failed: CUDA error {err}")
    if packed:
        launches += 1
    else:
        launches_dense += 1
    return vals, order, crs, cyc


def colskip_sort_batched(x, w: int = 32, k: int = 2, *,
                         stop_after: int | None = None, packed: bool = True,
                         device="cuda"):
    """Sort rows of ``x`` (B, N) 32-bit words ascending with the §III
    machine; returns ``(values, order, column_reads, cycles)``.

    ``values`` (B, stop) uint32, ``order`` (B, stop) int32, per-row CRs and
    cycles (B,) int32, as the reference's ``colskip_sort_batched``.
    ``stop_after=k'`` runs the k-early-exit drain (outputs (B, k')).
    ``packed`` picks the mask carrier (the outputs do not depend on it).
    ``x`` (a tensor or array) is moved to ``device``: on the card the
    carrier's CUDA kernel runs, on the CPU its plain machine of :mod:`.ref`.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    b, n = x.shape
    stop = n if stop_after is None else min(int(stop_after), n)
    if stop < 1:
        raise ValueError(f"stop_after={stop_after} must be >= 1")
    if dev.type == "cpu":
        return _ref.sort_ref(x, w, k, stop, packed=packed)
    return _launch(x.contiguous(), w, k, stop, packed)


def _launch_mesh(x: torch.Tensor, banks: int, w: int, k: int, stop: int,
                 fuse: int, packed: bool):
    """Launch the mesh kernel on ``x`` (B, N) 32-bit words on the card;
    returns the outputs and the (B,) exchange rounds of each row."""
    global launches_mesh, launches_mesh_dense
    if x.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"colskip mesh kernel takes 32-bit words, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("colskip mesh kernel takes a contiguous (B, N) tensor")
    b, n = x.shape
    lib = _mesh_lib()
    if not 1 <= banks <= lib.colskip_mesh_max_banks():
        raise ValueError(f"{banks} banks: the mesh kernel takes 1 to "
                         f"{lib.colskip_mesh_max_banks()} (a cluster)")
    if not 1 <= w <= 32:
        raise ValueError(f"w={w} out of range [1, 32]")
    if not 0 <= k <= lib.colskip_mesh_max_k():
        raise ValueError(f"k={k} out of range [0, {lib.colskip_mesh_max_k()}]"
                         " for the mesh kernel")
    dev = x.device
    with torch.cuda.device(dev):
        widest = lib.colskip_mesh_shard_max(int(packed), k)
    if n // banks > widest:
        carrier = "packed" if packed else "dense"
        raise ValueError(f"N={n} over {banks} banks: shards of {n // banks} > "
                         f"{widest}, the widest shard the {carrier} mesh "
                         f"kernel holds at k={k}")
    vals = torch.empty((b, stop), dtype=torch.uint32, device=dev)
    order = torch.empty((b, stop), dtype=torch.int32, device=dev)
    crs = torch.empty((b,), dtype=torch.int32, device=dev)
    cyc = torch.empty((b,), dtype=torch.int32, device=dev)
    rounds = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, order, crs, cyc, rounds
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.colskip_mesh_launch(
            x.data_ptr(), vals.data_ptr(), order.data_ptr(), crs.data_ptr(),
            cyc.data_ptr(), rounds.data_ptr(), b, n, banks, w, k, stop, fuse,
            int(packed), stream)
    if err != 0:
        raise RuntimeError(f"colskip mesh kernel launch failed: CUDA error "
                           f"{err}")
    if packed:
        launches_mesh += 1
    else:
        launches_mesh_dense += 1
    return vals, order, crs, cyc, rounds


def colskip_sort_mesh_batched(x, banks: int, w: int = 32, k: int = 2, *,
                              stop_after: int | None = None,
                              packed: bool = True, fuse: int = 1,
                              device="cuda", return_rounds: bool = False):
    """:func:`colskip_sort_batched` over a mesh of ``banks`` banks: each row
    of ``x`` (B, N) split into ``banks`` contiguous column shards, the
    §III machine run in every bank with the §IV manager's gates between
    them.  The outputs equal :func:`colskip_sort_batched`'s for any
    ``banks``, ``packed`` and ``fuse`` (§V.C).

    On the card the carrier's mesh kernel runs (one thread-block cluster a
    row, a CTA a bank), built for every ``fuse`` in :data:`MESH_FUSES`
    (1 to 8); on the CPU the plain mesh (:func:`.ref.sort_mesh_ref`).
    Another ``fuse`` raises :class:`ValueError`.  ``return_rounds=True``
    adds a fifth output: the (B,) cross-bank exchanges each row made on the
    kernel (None on the CPU, where rounds are not a property of the plain
    version)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    b, n = x.shape
    if banks < 1 or n % banks:
        raise ValueError(f"N={n} not divisible over {banks} mesh banks")
    stop = n if stop_after is None else min(int(stop_after), n)
    if stop < 1:
        raise ValueError(f"stop_after={stop_after} must be >= 1")
    if fuse not in MESH_FUSES:
        raise ValueError(f"fuse={fuse} out of range [1, 8]")
    if dev.type == "cpu":
        out = _ref.sort_mesh_ref(x, banks, w, k, stop, packed=packed,
                                 fuse=fuse)
        return (*out, None) if return_rounds else out
    out = _launch_mesh(x.contiguous(), banks, w, k, stop, fuse, packed)
    return out if return_rounds else out[:4]
