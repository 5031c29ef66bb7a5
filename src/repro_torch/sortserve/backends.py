"""Pluggable execution backends + cost-model-driven selection policy.

The torch port of :mod:`repro.sortserve.backends`.  A backend executes one
:class:`~repro_torch.sortserve.batcher.Tile` — a ``(B, N)`` uint32 array in
the sortable domain — and returns values/indices plus whatever hardware
telemetry it can model:

  ================  ====================  =================================
  backend           ops                   telemetry
  ================  ====================  =================================
  ``colskip``       sort, argsort, kmin   exact per-row CRs + cycles from the
                                          §III machine (the colskip CUDA
                                          kernel; its plain torch version on
                                          the CPU)
  ``colskip_mesh``  sort, argsort, kmin   the same, over a bank mesh (the
                                          mesh kernel on the card, the plain
                                          mesh on the CPU)
  ``radix_topk``    topk, kmin            per-row discriminating-plane reads;
                                          thresholds from the radix CUDA
                                          kernel (plain torch on the CPU)
  ``jaxsort``       sort, argsort, kmin   none (a stable comparison sort;
                                          serves widths beyond the
                                          simulation cap — the name is kept
                                          so priors and telemetry cross
                                          between the packages)
  ``numpy``         all                   none (reference oracle)
  ================  ====================  =================================

The torch backends run on ``device`` (default ``"cuda"``; it raises with
no card, and ``"cpu"`` runs the plain versions).  Selection is the
reference's :class:`CostPolicy`, copied unchanged (see its docstring):
selection ops route to ``radix_topk``; full sorts to ``colskip`` up to the
``sim_width_cap`` prior, past it to ``jaxsort``, with measured wall-clock
EMAs overriding the prior once both contenders have run.

Execution goes through a process-level :class:`ExecutorCache` of kernel
launchers keyed by the reference's tile signatures (plus the device): a
miss builds the launcher (and, on the card, loads or compiles the kernel
library), a hit goes straight to it.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import costmodel
from repro_torch.core.bitmatrix import WORD_MASK, as_words
from repro_torch.core.costmodel import estimate_colskip_cycles
from repro_torch.core.topk import discriminating_planes, exact_k_mask
from repro_torch.kernels.colskip import ops as colskip_ops
from repro_torch.kernels.radix_topk import ops as radix_ops

from .batcher import Tile

__all__ = [
    "BACKENDS",
    "Backend",
    "CostPolicy",
    "EXECUTOR_CACHE",
    "ExecutorCache",
    "TileResult",
    "estimate_colskip_cycles",
    "register_backend",
    "resolve_backends",
    "solve_numpy",
]


class ExecutorCache:
    """Process-level cache of tile launchers.

    Keys are full tile signatures — ``(backend, B, N, k/stop, flags...,
    device)`` — and values are callables that run one tile.  Building a
    launcher on the card loads the kernel library (compiling it with
    ``nvcc`` the first time in a checkout), so a miss is the port's
    analogue of the reference's AOT compile and a hit skips it.  The cache
    is process-global like the reference's; hit/miss counters feed the
    serving telemetry.
    """

    def __init__(self):
        self._fns: dict = {}
        self._building: dict = {}         # key -> Event for in-flight builds
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # the persistent layer underneath: an in-process miss whose kernel
        # library is already in the compile-cache directory is a load, not
        # an nvcc build — the split feeds executor_cache telemetry
        self.persistent_hits = 0
        self.persistent_misses = 0
        self.persistent_dir: str | None = None

    def enable_persistent(self, cache_dir) -> bool:
        """Keep the kernel libraries in ``cache_dir``
        (:func:`repro_torch.kernels._build.set_build_dir`).

        Every library a launcher needs is then looked up there: one found
        on disk is opened (a persistent hit), a missing one is built by
        ``nvcc`` into it (a miss), so a fresh process pointed at the same
        directory starts without a build.  Returns True.  Idempotent —
        re-enabling only repoints the directory."""
        from repro_torch.kernels import _build
        _build.set_build_dir(cache_dir, self._on_cache_event)
        self.persistent_dir = str(cache_dir)
        return True

    def _on_cache_event(self, event: str) -> None:
        # one event per library opened from the compile-cache directory
        with self._lock:
            if event == "hit":
                self.persistent_hits += 1
            elif event == "miss":
                self.persistent_misses += 1

    def persistent_counters(self) -> tuple[int, int]:
        with self._lock:
            return self.persistent_hits, self.persistent_misses

    def get(self, key, build):
        """Return ``(launcher, warm)`` for ``key``, building on miss.

        ``warm`` is per-call truth: False when this call built *or waited
        on* the build — either way its wall time is build-dominated and must
        not feed the routing EMA.  Concurrent misses on one key run a
        single build; the rest wait."""
        while True:
            with self._lock:
                fn = self._fns.get(key)
                if fn is not None:
                    self.hits += 1
                    return fn, True
                event = self._building.get(key)
                if event is None:
                    event = threading.Event()
                    self._building[key] = event
                    break                     # we build
            event.wait()                      # someone else is building
            with self._lock:
                fn = self._fns.get(key)
                if fn is not None:
                    return fn, False          # shared the build's latency
            # builder failed: loop and take over the build
        fn = None
        try:
            fn = build()                      # build outside the lock
        finally:
            with self._lock:
                if fn is not None:
                    self._fns[key] = fn
                self.misses += 1
                self._building.pop(key, None)
                event.set()                   # waiters re-check (or rebuild)
        return fn, False

    def counters(self) -> tuple[int, int, int]:
        with self._lock:
            return self.hits, self.misses, len(self._fns)

    def clear(self) -> None:
        with self._lock:
            self._fns.clear()
            self.hits = self.misses = 0


EXECUTOR_CACHE = ExecutorCache()


def _tensor(data: np.ndarray, device: torch.device) -> torch.Tensor:
    """A tile's uint32 rows on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(data, np.uint32)).to(device)


def _colskip_launcher(b: int, n: int, w: int, state_k: int,
                      stop: int | None, packed: bool, device: torch.device):
    """Warm launcher for one colskip tile signature on one mask carrier."""
    key = ("colskip", b, n, w, state_k, stop, packed, str(device))

    def build():
        if device.type == "cuda":
            colskip_ops._lib()                # load (or compile) the kernel
        return functools.partial(colskip_ops.colskip_sort_batched, w=w,
                                 k=state_k, stop_after=stop, packed=packed,
                                 device=device)
    return EXECUTOR_CACHE.get(key, build)     # -> (fn, warm)


@dataclass
class TileResult:
    """Backend output for one tile (all arrays row-aligned with the tile)."""

    values: np.ndarray                  # (B, out) uint32, sortable domain
    indices: np.ndarray | None          # (B, out) int32 positions, or None
    column_reads: np.ndarray | None     # (B,) per-row CR/plane-read counts
    cycles: np.ndarray | None           # (B,) per-row HW cycles (exact only)
    backend: str
    estimated_cycles: float | None = None   # cost-model estimate when not exact
    meta: dict = field(default_factory=dict)

    def modeled_cycles(self) -> float | None:
        """The tile's total modeled-cycle count in the §V domain: the exact
        per-row cycle telemetry summed when the backend simulates it, the
        cost-model estimate otherwise, None when neither exists (numpy
        oracle, radix plane reads) — the denominator of the engine's
        measured-vs-modeled calibration ratio."""
        if self.cycles is not None:
            return float(int(self.cycles.sum()))
        if self.estimated_cycles is not None:
            return float(self.estimated_cycles)
        return None


def solve_numpy(op: str, u: np.ndarray, k: int | None) -> tuple[np.ndarray, np.ndarray]:
    """Reference answer for one encoded row: (values_u32, indices).

    Shared by the numpy backend, the engine's verify mode, and the CLI/test
    oracles, so "bit-identical to the numpy oracle" is a single definition.
    """
    u = np.asarray(u, dtype=np.uint32)
    if op in ("sort", "argsort"):
        idx = np.argsort(u, kind="stable").astype(np.int32)
        return u[idx], idx
    if op == "kmin":
        idx = np.argsort(u, kind="stable")[:k].astype(np.int32)
        return u[idx], idx
    if op == "topk":
        # descending value, ascending-index ties: stable sort on bitwise-not
        idx = np.argsort(~u, kind="stable")[:k].astype(np.int32)
        return u[idx], idx
    raise ValueError(f"unknown op {op!r}")


class Backend:
    """Base class: subclasses set ``name``/``ops`` and implement ``run``."""

    name: str = "?"
    ops: frozenset = frozenset()

    def run(self, tile: Tile) -> TileResult:  # pragma: no cover - interface
        raise NotImplementedError

    def warm(self, b: int, n: int, op: str, k: int | None) -> bool:
        """Build this backend's launcher for a tile signature ahead of use.

        Session prewarming (``SortServeEngine.begin(traffic_class=...)``)
        calls this for every signature in the class's recorded menu, so the
        first real tile of a new session lands on a warm launcher.
        Returns True only when this call actually built (a cache miss) —
        an already-warm signature, or a backend with no launcher (the base
        class, the numpy oracle), returns False, so the engine's
        ``prewarmed`` counter measures real builds."""
        return False

    def __repr__(self):
        return f"<{type(self).__name__} {self.name} ops={sorted(self.ops)}>"


BACKENDS: dict[str, type[Backend]] = {}


def register_backend(cls: type[Backend]) -> type[Backend]:
    BACKENDS[cls.name] = cls
    return cls


def resolve_backends(names, **kwargs) -> list[Backend]:
    """Instantiate backends by name; unknown names raise with the menu."""
    out = []
    for name in names:
        if name not in BACKENDS:
            raise KeyError(f"unknown backend {name!r}; have {sorted(BACKENDS)}")
        out.append(BACKENDS[name](**kwargs.get(name, {})))
    return out


@register_backend
class NumpyBackend(Backend):
    """Pure-numpy oracle; supports every op, models no hardware."""

    name = "numpy"
    ops = frozenset(("sort", "argsort", "topk", "kmin"))

    def run(self, tile: Tile) -> TileResult:
        b, _ = tile.data.shape
        out = tile.k if tile.op in ("topk", "kmin") else tile.data.shape[1]
        vals = np.empty((b, out), np.uint32)
        idxs = np.empty((b, out), np.int32)
        for r in range(b):
            vals[r], idxs[r] = solve_numpy(tile.op, tile.data[r], tile.k)
        return TileResult(vals, idxs, None, None, self.name)


@register_backend
class ColskipBackend(Backend):
    """Cycle-exact column-skipping sorter (§III machine, batched) on the
    colskip kernel.

    ``kmin`` runs the k-early-exit drain: the machine stops after the
    tile's k minima have drained, so the CR/cycle telemetry covers only the
    executed iterations instead of a complete sort.  ``packed=False``
    serves on the dense carrier's kernel (bit-identical outputs).
    """

    name = "colskip"
    ops = frozenset(("sort", "argsort", "kmin"))

    def __init__(self, w: int = 32, state_k: int = 2, packed: bool = True,
                 device="cuda"):
        self.w = w
        self.state_k = state_k
        self.packed = packed
        self.device = resolve_device(device)

    def run(self, tile: Tile) -> TileResult:
        stop = tile.k if tile.op == "kmin" else None
        b, n = tile.data.shape
        fn, warm = _colskip_launcher(b, n, self.w, self.state_k, stop,
                                     self.packed, self.device)
        vals, order, crs, cycles = fn(_tensor(tile.data, self.device))
        return TileResult(vals.cpu().numpy(), order.cpu().numpy(),
                          crs.cpu().numpy().astype(np.int64),
                          cycles.cpu().numpy().astype(np.int64),
                          self.name, meta={"w": self.w, "state_k": self.state_k,
                                           "stop_after": stop,
                                           "packed": self.packed,
                                           "exec_warm": warm})

    def warm(self, b: int, n: int, op: str, k: int | None) -> bool:
        stop = k if op == "kmin" else None
        _, hit = _colskip_launcher(b, n, self.w, self.state_k, stop,
                                   self.packed, self.device)
        return not hit


@register_backend
class ShardedColskipBackend(Backend):
    """Column-skipping sorter over a bank mesh (§IV on one card).

    Executes each tile through
    :func:`repro_torch.dist.bankmesh.colskip_sort_mesh`: a row's columns
    split over the mesh's banks, the mixed-column judgement one OR-gate
    exchange per fused block of planes — on the card the mesh kernel (a
    thread-block cluster a row, a CTA a bank), on the CPU the plain mesh.
    Values, order, and CR/cycle telemetry are bit-identical to
    :class:`ColskipBackend` — §V.C's invariance of column skipping under
    multi-bank management — so the cost policy treats both simulators
    interchangeably.  Tiles whose width does not divide over the mesh run
    on one bank, the local colskip kernel (same telemetry, by the same
    invariance; ``meta["mesh_banks"] == 1``).

    ``kernel_rounds`` / ``static_rounds`` (class-wide, reset by
    :meth:`reset_rounds`) sum over the mesh tiles run on the card the
    exchanges the kernel made on the tile's slowest row and the
    reference's static account (:func:`collective_rounds`), which the
    engine's ``collectives`` telemetry reports.
    """

    name = "colskip_mesh"
    ops = frozenset(("sort", "argsort", "kmin"))
    kernel_rounds = 0
    static_rounds = 0

    def __init__(self, w: int = 32, state_k: int = 2, mesh=None,
                 axis_name="banks", packed: bool = True, fuse: int = 1,
                 device="cuda"):
        from repro_torch.dist.bankmesh import (
            make_bank_mesh,
            topology_fingerprint,
        )
        self.w = w
        self.state_k = state_k
        self.axis_name = axis_name
        self.packed = packed
        self.fuse = fuse
        self.mesh = mesh if mesh is not None else make_bank_mesh(
            axis_name=axis_name, device=device)
        self.device = self.mesh.device
        if self.device.type == "cuda" and fuse not in colskip_ops.MESH_FUSES:
            # refuse what the mesh kernel is not built for now, not at the
            # first mesh tile
            raise NotImplementedError(
                f"fuse={fuse}: the mesh kernel is built for fuse in "
                f"{colskip_ops.MESH_FUSES} (ROADMAP Queue 1)")
        # launcher keys carry the topology fingerprint, NOT the mesh object:
        # an equal mesh rebuilt after a restart must hit, not rebuild
        self._fingerprint = topology_fingerprint(self.mesh)
        # double buffer: id(tile) -> (tile, staged tensor, copy event)
        # staged by prefetch() while the previous tile runs.  Two slots,
        # FIFO-evicted: admitting tile X stages its successor Y before X
        # executes, so X's own staged entry must survive one more staging
        self._staged: dict = {}
        self._copy_stream = None

    @classmethod
    def reset_rounds(cls) -> None:
        cls.kernel_rounds = cls.static_rounds = 0

    @property
    def n_devices(self) -> int:
        from repro_torch.dist.bankmesh import mesh_banks
        return mesh_banks(self.mesh, self.axis_name)

    def _on_mesh(self, n: int) -> bool:
        return n % self.n_devices == 0 and self.n_devices > 1

    def _mesh_launcher(self, b: int, n: int, stop_eff: int):
        from repro_torch.dist.bankmesh import colskip_sort_mesh
        key = ("colskip_mesh", b, n, self.w, self.state_k, stop_eff,
               self.packed, self.fuse, self.n_devices, self._fingerprint)

        def build():
            if self.device.type == "cuda":
                colskip_ops._mesh_lib()       # load (or compile) the kernel
            return functools.partial(
                colskip_sort_mesh, mesh=self.mesh, w=self.w, k=self.state_k,
                axis_name=self.axis_name, stop_after=stop_eff,
                packed=self.packed, fuse=self.fuse)
        # built through the executor cache (like the local backends), so a
        # cold mesh tile is visible as a cache miss — the engine's
        # warm-only EMA gate depends on that
        return EXECUTOR_CACHE.get(key, build)

    def _stage(self, data: np.ndarray):
        """The tile on the mesh's device: on the card a host-to-device copy
        from pinned memory on a side stream, with the event that marks its
        end; on the CPU the tensor itself."""
        host = torch.from_numpy(np.ascontiguousarray(data, np.uint32))
        if self.device.type != "cuda":
            return host, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        pinned = host.pin_memory()
        with torch.cuda.stream(self._copy_stream):
            staged = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return staged, done

    def prefetch(self, tile: Tile) -> bool:
        """Stage the next tile's device transfer (double buffering).

        Called by the scheduler right before the current tile executes:
        the copy runs on a side stream while the current tile traverses
        planes, and :meth:`run` waits on its event before launching.  Two
        slots, oldest evicted; restaging a tile refreshes it.  Returns
        True when a transfer was staged."""
        if not self._on_mesh(tile.data.shape[1]):
            return False                 # one-bank fallback: nothing to hide
        self._staged.pop(id(tile), None)
        self._staged[id(tile)] = (tile, *self._stage(tile.data))
        while len(self._staged) > 2:
            del self._staged[next(iter(self._staged))]
        return True

    def run(self, tile: Tile) -> TileResult:
        from repro_torch.dist.bankmesh import collective_rounds
        b, n = tile.data.shape
        stop = tile.k if tile.op == "kmin" else None
        staged = self._staged.pop(id(tile), None)
        # the identity re-check guards id() reuse after a staged tile died
        prefetch_hit = staged is not None and staged[0] is tile
        coll = {"coll_rounds": 0, "coll_planes": 0, "coll_unfused_rounds": 0}
        if self._on_mesh(n):
            stop_eff = min(stop, n) if stop is not None else n
            fn, warm = self._mesh_launcher(b, n, stop_eff)
            if prefetch_hit:
                arr, done = staged[1], staged[2]
                if done is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(done)
                    arr.record_stream(cur)
            else:
                arr = _tensor(tile.data, self.device)
            vals, order, crs, cycles, rounds = fn(arr, return_rounds=True)
            banks_used = self.n_devices
            acct = collective_rounds(self.w, stop_eff, self.fuse)
            coll = {"coll_rounds": acct["rounds"],
                    "coll_planes": acct["planes"],
                    "coll_unfused_rounds": acct["unfused_rounds"]}
            if rounds is not None:
                cls = type(self)
                cls.kernel_rounds += int(rounds.max())
                cls.static_rounds += acct["rounds"]
        else:
            fn, warm = _colskip_launcher(b, n, self.w, self.state_k, stop,
                                         self.packed, self.device)
            vals, order, crs, cycles = fn(_tensor(tile.data, self.device))
            banks_used = 1
        return TileResult(vals.cpu().numpy(), order.cpu().numpy(),
                          crs.cpu().numpy().astype(np.int64),
                          cycles.cpu().numpy().astype(np.int64), self.name,
                          meta={"w": self.w, "state_k": self.state_k,
                                "stop_after": stop, "mesh_banks": banks_used,
                                "packed": self.packed, "exec_warm": warm,
                                "fuse": self.fuse,
                                "prefetch_hit": prefetch_hit, **coll})

    def warm(self, b: int, n: int, op: str, k: int | None) -> bool:
        stop = k if op == "kmin" else None
        if self._on_mesh(n):
            stop_eff = min(stop, n) if stop is not None else n
            _, hit = self._mesh_launcher(b, n, stop_eff)
        else:
            _, hit = _colskip_launcher(b, n, self.w, self.state_k, stop,
                                       self.packed, self.device)
        return not hit


@register_backend
class RadixTopkBackend(Backend):
    """Bit-plane radix selection in the sortable-uint32 domain.

    The per-row threshold comes from the radix kernel's sortable entry
    (:func:`~repro_torch.kernels.radix_topk.ops.threshold_sortable`) — the
    function the reference computes here in jnp
    (``kth_largest_sortable``), so values, indices and telemetry are the
    reference's.  ``kmin`` is served as top-k on the bitwise complement
    (an order reversal in uint32), which keeps the ascending-index
    tie-break exactly.
    """

    name = "radix_topk"
    ops = frozenset(("topk", "kmin"))

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _launcher(self, b: int, n: int, k: int, kmin: bool):
        key = ("radix_topk", b, n, k, kmin, str(self.device))

        def build():
            if self.device.type == "cuda":
                radix_ops._lib()              # load (or compile) the kernel
            return functools.partial(_radix_select, k=k, kmin=kmin,
                                     device=self.device)
        return EXECUTOR_CACHE.get(key, build)

    def run(self, tile: Tile) -> TileResult:
        b, n = tile.data.shape
        fn, warm = self._launcher(b, n, tile.k, tile.op == "kmin")
        vals, idxs, reads = fn(tile.data)
        return TileResult(vals, idxs, reads, None, self.name,
                          meta={"planes_max": int(reads.max(initial=0)),
                                "exec_warm": warm})

    def warm(self, b: int, n: int, op: str, k: int | None) -> bool:
        if k is None:
            return False                    # selection ops always carry k
        _, hit = self._launcher(b, n, k, op == "kmin")
        return not hit


@register_backend
class JaxSortBackend(Backend):
    """Stable comparison sort — the wide-row fallback past the simulation
    cap.  Keeps the reference's backend name so that priors, warm state
    and telemetry apply to both packages."""

    name = "jaxsort"
    ops = frozenset(("sort", "argsort", "kmin"))

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _launcher(self, b: int, n: int):
        return EXECUTOR_CACHE.get(
            ("jaxsort", b, n, str(self.device)),
            lambda: functools.partial(_stable_argsort, device=self.device))

    def run(self, tile: Tile) -> TileResult:
        b, n = tile.data.shape
        fn, warm = self._launcher(b, n)
        order = fn(tile.data)
        vals = np.take_along_axis(tile.data, order, axis=-1)
        if tile.op == "kmin":
            vals, order = vals[:, :tile.k], order[:, :tile.k]
        est = estimate_colskip_cycles(n) * b
        return TileResult(vals, order, None, None, self.name,
                          estimated_cycles=est, meta={"exec_warm": warm})

    def warm(self, b: int, n: int, op: str, k: int | None) -> bool:
        self._launcher(b, n)
        return True


def _stable_argsort(data: np.ndarray, device: torch.device) -> np.ndarray:
    """Stable ascending argsort of uint32 rows, as int32.  It sorts an
    int64 copy: uint32 sorting is not relied on."""
    keys = as_words(_tensor(data, device))
    return torch.argsort(keys, dim=-1, stable=True).to(torch.int32).cpu().numpy()


def _radix_select(data: np.ndarray, k: int, kmin: bool, device: torch.device):
    """Tile body: (B, N) sortable uint32 -> (values, indices, plane reads).

    ``kmin`` selects the k smallest by descending on the bitwise complement
    (an order reversal in uint32), then complements the values back."""
    u = as_words(_tensor(data, device))
    d = u ^ WORD_MASK if kmin else u
    thresh, _ = radix_ops.threshold_sortable(d.to(torch.int32), k,
                                             device=device)
    mask = exact_k_mask(d, as_words(thresh)[:, None], k)
    vals, idxs = radix_ops.compact_sortable(d, mask, k)
    if kmin:
        vals = vals ^ WORD_MASK
    # one CR per discriminating plane per row; uniform planes are skipped
    reads = discriminating_planes(u).sum(-1)
    return (vals.cpu().numpy().astype(np.uint32), idxs.cpu().numpy(),
            reads.cpu().numpy().astype(np.int64))


class CostPolicy:
    """Route each tile to the cheapest capable backend (see module docstring).

    Two-layer decision:

      1. **Measured** — every executed tile feeds a per-``(backend, op,
         width)`` wall-clock EMA via :meth:`observe`; when both contenders
         of a decision are measured, the lower EMA wins outright.
      2. **Prior** — with no (or one-sided) measurements the §V cost model
         anchors and the static ``sim_width_cap`` software guard decide,
         exactly as before.  Once the prior's pick has been measured
         ``explore_after`` times while the alternative never ran, the policy
         routes one tile to the alternative so the comparison becomes
         measured (bounded exploration; disable with ``adaptive=False``).

    Sessions opened with a **traffic class** keep private per-class EMA
    priors on top of the engine-global one (a class's widths/ops can race
    differently from the aggregate stream); the global prior is always fed
    too and serves as the fallback until the class has its own samples.
    """

    def __init__(self, backends, sim_width_cap: int = 2048, w: int = 32, *,
                 adaptive: bool = True, ema_alpha: float = 0.25,
                 explore_after: int = 16):
        self.backends = list(backends)
        self.by_name = {b.name: b for b in self.backends}
        self.sim_width_cap = sim_width_cap
        self.w = w
        self.adaptive = adaptive
        self.ema_alpha = float(ema_alpha)
        self.explore_after = int(explore_after)
        # (backend, op, N, k, traffic_class) -> s/row EMA / sample count;
        # traffic_class None is the engine-global prior every class falls
        # back to until its own stream has been measured
        self._ema: dict[tuple, float] = {}
        self._obs: dict[tuple, int] = {}

    # ------------------------------------------------------------ measured
    def observe(self, backend_name: str, op: str, n: int, rows: int,
                wall_s: float, k: int | None = None,
                traffic_class: str | None = None) -> None:
        """Feed one measured tile execution into the per-signature EMA.

        ``k`` is part of the signature: a kmin tile's simulator cost scales
        with its drain count, so different k must never share an EMA.
        ``traffic_class`` additionally updates that class's private prior
        (sessions opened with ``begin(traffic_class=...)``) — the global
        (class-None) EMA is always updated too, so unclassified traffic
        keeps learning from every execution."""
        per_row = wall_s / max(1, rows)
        for cls in ({None, traffic_class} if traffic_class is not None
                    else (None,)):
            key = (backend_name, op, int(n), k, cls)
            prev = self._ema.get(key)
            self._ema[key] = per_row if prev is None else (
                (1.0 - self.ema_alpha) * prev + self.ema_alpha * per_row)
            self._obs[key] = self._obs.get(key, 0) + 1

    def export_priors(self, include_classes: bool = False) -> list[dict]:
        """The measured EMAs as a portable profile (the ``priors`` block
        of an hw_tune profile).  By default class-private EMAs are
        excluded — they describe one session's traffic — matching the
        hw_tune contract.  ``include_classes=True`` keeps them (with a
        ``traffic_class`` field on every row) for warm-state artifacts
        (the reference's ``repro.sortserve.fleet``), where per-class priors are exactly
        the point of persisting."""
        out = []
        for key in sorted(self._ema, key=repr):
            backend, op, n, k, cls = key
            if cls is not None and not include_classes:
                continue
            row = {"backend": backend, "op": op, "n": n, "k": k,
                   "s_per_row": self._ema[key],
                   "samples": self._obs.get(key, 0)}
            if include_classes:
                row["traffic_class"] = cls
            out.append(row)
        return out

    def load_priors(self, priors) -> int:
        """Seed EMAs from a measured profile (``scripts/hw_tune.py`` or a
        warm-state artifact).  Live measurements outrank the profile:
        a signature that already has samples is left alone, and every
        loaded prior keeps updating from real traffic through
        :meth:`observe`.  Rows without a ``traffic_class`` field seed the
        engine-global prior; rows with one seed that class's private EMA.
        Returns the number of signatures seeded."""
        count = 0
        for p in priors:
            cls = p.get("traffic_class")
            key = (p["backend"], p["op"], int(p["n"]),
                   None if p.get("k") is None else int(p["k"]),
                   None if cls is None else str(cls))
            if key in self._ema:
                continue
            self._ema[key] = float(p["s_per_row"])
            self._obs[key] = max(1, int(p.get("samples", 1)))
            count += 1
        return count

    def measured_s_per_row(self, backend_name: str, op: str, n: int,
                           k: int | None = None,
                           traffic_class: str | None = None) -> float | None:
        """Current EMA for a signature (class-specific first, then the
        global prior), or None if never executed."""
        if traffic_class is not None:
            v = self._ema.get((backend_name, op, int(n), k, traffic_class))
            if v is not None:
                return v
        return self._ema.get((backend_name, op, int(n), k, None))

    def _pick_measured(self, a: Backend, b: Backend, op: str, n: int,
                       k: int | None, allow_explore: bool = True,
                       traffic_class: str | None = None):
        """Measured EMA comparison / bounded exploration between a (the
        prior's pick) and b (the alternative); None -> keep the prior."""
        if not self.adaptive or b is None:
            return None
        ea = self.measured_s_per_row(a.name, op, n, k, traffic_class)
        eb = self.measured_s_per_row(b.name, op, n, k, traffic_class)
        if ea is not None and eb is not None:
            return a if ea <= eb else b
        if allow_explore and eb is None and \
                self._obs.get((a.name, op, int(n), k, None),
                              0) >= self.explore_after:
            return b                        # one probe makes it a measured race
        return None

    # --------------------------------------------------------------- prior
    def modeled_throughput(self, n: int, state_k: int = 2,
                           banks: int = 1) -> float:
        """Numbers/s the modeled hardware would sustain on this width."""
        cpn = estimate_colskip_cycles(n, self.w) / n
        return costmodel.colskip_cost(cpn, n=n, w=self.w, k=state_k,
                                      banks=banks).throughput_num_per_s

    def choose(self, tile: Tile,
               traffic_class: str | None = None) -> Backend:
        if tile.hint is not None:       # hints are uniform per tile (bucket key)
            if tile.hint not in self.by_name:
                raise KeyError(f"hinted backend {tile.hint!r} not enabled")
            be = self.by_name[tile.hint]
            if tile.op not in be.ops:
                raise ValueError(f"backend {tile.hint!r} cannot serve {tile.op!r}")
            return be
        cands = [b for b in self.backends if tile.op in b.ops]
        if not cands:
            raise ValueError(f"no enabled backend serves op {tile.op!r}")
        n = tile.data.shape[1]
        if tile.op in ("topk", "kmin"):
            # radix descent: <= w plane reads + k compaction passes per row,
            # vs colskip's ~ n*w/4.08 CR cycles for the full min-search sort.
            radix_cost = self.w + (tile.k or 0)
            if radix_cost < estimate_colskip_cycles(n, self.w):
                for b in cands:
                    if b.name == "radix_topk":
                        return b
        by_name = {b.name: b for b in cands}
        # both cycle-exact simulators (local and mesh-sharded) rank the same:
        # §V.C — bank management never changes the modeled latency
        sim = next((by_name[nm] for nm in ("colskip", "colskip_mesh")
                    if nm in by_name), None)
        fast = next((by_name[nm] for nm in ("jaxsort", "numpy")
                     if nm in by_name), None)
        if sim is not None and fast is not None:
            # prior: simulate up to the cap; measured EMAs override it.  An
            # exploration probe *toward the simulator* is only allowed within
            # 2x the cap — the sim is O(N*w) per output element, and a probe
            # at arbitrary width would stall the engine for exactly the
            # pathological case the cap exists to prevent.
            prior, alt = (sim, fast) if n <= self.sim_width_cap else (fast, sim)
            allow = alt is not sim or n <= 2 * self.sim_width_cap
            return self._pick_measured(prior, alt, tile.op, n, tile.k,
                                       allow, traffic_class) or prior
        if sim is not None and n <= self.sim_width_cap:
            return sim                    # cycle-exact simulation, affordable
        # past the cap: any non-simulating backend before the O(N*w)-per-
        # output simulator, which is only a last resort
        if fast is not None:
            return fast
        return sim if sim is not None else cands[0]
