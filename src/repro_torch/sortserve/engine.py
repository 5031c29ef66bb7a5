"""The serving loop: streaming sessions, sync submit, async front door.

The torch port of :mod:`repro.sortserve.engine`: the same engine, whose
backends run the port's kernels on ``EngineConfig.device`` (default
``"cuda"``; ``"cpu"`` runs the plain torch versions).  ``mesh=True``
serves through :class:`~repro_torch.dist.bankmesh.MeshBankPool`, whose
``colskip_mesh`` backend runs the mesh kernel on the card (a thread-block
cluster a row, a CTA a bank) and the plain mesh on the CPU.
``compile_cache=dir`` keeps the kernel libraries in ``dir``, the port's
counterpart of jax's persistent compilation cache: a fresh process pointed
at the same directory opens them instead of running ``nvcc``
(``executor_cache.persistent_{hits,misses}``).  :func:`config_from_reference`
builds a config from the reference's.

The data path is session-shaped (the continuous core is the only core):

    session = engine.begin(traffic_class=...)
    session.feed(requests)   --encode--> per-session Batcher (closes buckets
                             on size or age) --tiles--> ContinuousScheduler
                             (event-clock admission as banks drain, gated by
                             the AdmissionPolicy under overload)
                             --CostPolicy--> backend.run --> scatter
    session.poll()/drain()   --> responses as their tiles retire

``SortServeEngine.submit`` serves batch callers as a thin
**feed-then-drain wrapper** over one ephemeral session, with ingress
validation and all-or-nothing telemetry rollback.  :class:`AsyncSortServe`
feeds a long-lived streaming session directly from its collector thread —
requests wait only on their own bucket's size/age closure, and the front
door is *bounded*: ``max_inflight`` caps accepted-but-unresolved futures
(excess submissions fail fast with :class:`RetryAfter`), and tiles shed by
the engine's :class:`~repro_torch.sortserve.scheduler.AdmissionPolicy` surface
as :class:`RetryAfter` on the caller's future instead of growing the event
heap.

Sessions opened with ``begin(traffic_class=...)`` get two extras: the
:class:`~repro_torch.sortserve.backends.CostPolicy` keeps a private measured-EMA
prior per class, and the executor cache is **prewarmed** at ``begin()``
with the class's recorded tile-signature menu, so a new session's first
tiles land on warm kernel launchers.

Event-model invariants the engine layers on top of the scheduler's (see
:mod:`repro_torch.sortserve.scheduler`): responses are delivered **exactly
once** per fed request; per-request latency spans feed -> retire on the
engine's injectable ``clock``; a failed or shed request leaves the session
entirely (re-feedable, surfaced via ``take_failures``), and a failed
``submit`` rolls every telemetry counter back.  Everything is
deterministic given the injectable ``clock``; the bank-pool event clock
itself runs in virtual hardware cycles and never sleeps.

Telemetry is aggregated across sessions/submits and exported by
:meth:`SortServeEngine.telemetry` / :meth:`dump_telemetry`:

  * per-request latency (mean / p50 / p95 / max),
  * aggregate column reads and hardware cycles, split exact vs estimated,
  * batcher stats (tiles, padding fractions, launcher-signature bucket hit
    rate),
  * scheduler stats (per-bank occupancy, drains, oversized waves, plus the
    event-clock section: admissions, queue waits, occupancy, makespan),
  * per-backend request/row counts,
  * the cost model's throughput for the modeled hardware at each width;

per-session slices of the same quantities come from
:meth:`SortSession.telemetry`.
"""

from __future__ import annotations

import copy
import heapq
import json
import queue
import threading
import time
import dataclasses
import hashlib
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.obs.aggregate import TelemetrySnapshot, capture
from repro_torch.obs.calibration import CalibrationTable
from repro_torch.obs.export import render_openmetrics
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.slo import SLOTracker

from .backends import (
    EXECUTOR_CACHE,
    CostPolicy,
    TileResult,
    resolve_backends,
    solve_numpy,
)
from .batcher import Batcher, Tile
from .faults import (
    BankHealth,
    CorruptResultError,
    FaultInjector,
    RecoveryPolicy,
    verify_tile_result,
)
from .request import SortRequest, SortResponse, decode_values
from .scheduler import BankPool, ContinuousScheduler, ShedError

__all__ = ["AsyncSortServe", "BackoffPolicy", "EngineConfig", "RetryAfter",
           "SortServeEngine", "SortSession", "config_from_reference"]


class RetryAfter(RuntimeError):
    """Caller-visible backpressure from the async front door.

    Raised on a future when the service is over capacity — the inflight
    bound was hit, or the engine's admission policy shed the request.  The
    caller should back off ``retry_after_s`` seconds and resubmit; the
    request was **not** executed (deterministic rejection, never a silent
    drop)."""

    def __init__(self, message: str, retry_after_s: float = 0.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


@dataclass
class EngineConfig:
    backends: tuple = ("colskip", "radix_topk", "jaxsort", "numpy")
    tile_rows: int = 8
    min_bucket: int = 8
    banks: int = 8
    bank_width: int = 1024
    bank_rows: int = 8
    w: int = 32                     # bit width of the sortable domain
    state_k: int = 2                # colskip state-recording entries
    sim_width_cap: int = 2048       # width prior for the cycle-exact sim
    verify: bool = False            # cross-check every response vs the oracle
    mesh: bool = False              # MeshBankPool: shard groups on the banks
                                    # of a mesh (a cluster's CTAs on the card)
    mesh_hosts: int = 1             # >1: hierarchical 2-axis hosts x banks
                                    # mesh (the same banks, folded)
    fuse: int = 1                   # bit planes per fused manager round on
                                    # the mesh path (results fuse-invariant)
    compile_cache: str | None = None  # persistent kernel-library cache dir
    cache_size: int = 1024          # result-cache entries (0 disables)
    packed: bool = True             # lane-packed masks in the §III machine
                                    # (False: the dense carrier)
    adaptive_policy: bool = True    # measured-EMA routing over the cap prior
    admission: object | None = None  # AdmissionPolicy (e.g. WatermarkPolicy)
                                     # gating arrivals; None accepts all
    tracer: object | None = None     # repro_torch.obs.Tracer: per-request
                                     # span chains + scheduler events; None (the
                                     # default) keeps the serving path
                                     # recorder-free
    metrics_window_s: float = 60.0   # sliding window behind telemetry "window"
    slo: dict | None = None          # traffic-class -> SLOTarget
                                     # (repro_torch.obs): burn-rate tracking behind
                                     # telemetry()["slo"]; None disables
    faults: object | None = None     # FaultPlan (sortserve.faults):
                                     # seeded bank fault injection + verified
                                     # retry/quarantine recovery; None (the
                                     # default) keeps the execute path a
                                     # strict no-op (golden byte-identical)
    device: str = "cuda"             # where the backends run; "cpu" runs
                                     # the plain torch versions
    backend_kwargs: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.tile_rows > self.bank_rows:
            raise ValueError(
                f"tile_rows={self.tile_rows} exceeds bank_rows={self.bank_rows}; "
                "tiles would never fit a bank")
        if not 1 <= self.fuse <= 8:
            raise ValueError(f"fuse={self.fuse} out of range [1, 8]")
        if self.mesh_hosts < 1:
            raise ValueError(f"mesh_hosts={self.mesh_hosts} must be >= 1")
        if self.mesh_hosts > 1 and not self.mesh:
            raise ValueError("mesh_hosts > 1 needs mesh=True (the hosts "
                             "axis only exists on the mesh pool)")
        resolve_device(self.device)


class SortServeEngine:
    """Synchronous sort-serving core over a pool of logical banks."""

    def __init__(self, config: EngineConfig | None = None, *,
                 clock=None):
        self.config = config or EngineConfig()
        self._clock = clock if clock is not None else time.perf_counter
        kwargs = dict(self.config.backend_kwargs)
        # w/state_k are owned by EngineConfig (the CostPolicy and telemetry
        # are computed from them); a conflicting per-backend override would
        # silently desync simulated cycles from the modeled hardware
        for sim in ("colskip", "colskip_mesh"):
            clash = {"w", "state_k"} & set(kwargs.get(sim, {}))
            if clash:
                raise ValueError(
                    f"set {sorted(clash)} via EngineConfig, "
                    f"not backend_kwargs[{sim!r}]")
            kwargs[sim] = {**kwargs.get(sim, {}),
                           "w": self.config.w, "state_k": self.config.state_k}
            # engine-level execution flags; explicit backend_kwargs win
            kwargs[sim].setdefault("packed", self.config.packed)
        for name in ("colskip", "colskip_mesh", "radix_topk", "jaxsort"):
            kwargs[name] = {**kwargs.get(name, {})}
            kwargs[name].setdefault("device", self.config.device)
        if self.config.compile_cache:
            # persistent kernel-library cache under the executor cache:
            # every library a launcher builds below lands on disk, and a
            # fresh process pointed at the same directory opens it instead
            # of running nvcc
            EXECUTOR_CACHE.enable_persistent(self.config.compile_cache)
        if self.config.mesh:
            from repro_torch.dist.bankmesh import MeshBankPool
            self.pool = MeshBankPool(self.config.banks, self.config.bank_width,
                                     self.config.bank_rows,
                                     hosts=self.config.mesh_hosts,
                                     device=self.config.device)
            # the mesh backend executes on the pool's own bank mesh
            kwargs["colskip_mesh"].setdefault("mesh", self.pool.mesh)
            kwargs["colskip_mesh"].setdefault("axis_name", self.pool.axis_name)
            kwargs["colskip_mesh"].setdefault("fuse", self.config.fuse)
        else:
            self.pool = BankPool(self.config.banks, self.config.bank_width,
                                 self.config.bank_rows)
        self.backends = resolve_backends(self.config.backends, **kwargs)
        self.policy = CostPolicy(self.backends,
                                 sim_width_cap=self.config.sim_width_cap,
                                 w=self.config.w,
                                 adaptive=self.config.adaptive_policy)
        self.batcher = Batcher(self.config.tile_rows, self.config.min_bucket)
        # flight recorder (opt-in) + always-on windowed metrics/calibration;
        # the tracer doubles as the scheduler's event hook so ARRIVE/ADMIT/
        # DEFER/SHED/EARLY/RETIRE land in the same stream as request spans
        self._tracer = self.config.tracer
        self._metrics = MetricsRegistry(self.config.metrics_window_s)
        self._calib = CalibrationTable()
        # per-traffic-class SLO burn-rate tracking (opt-in, like the tracer);
        # fed at the same hook points as the windowed metrics, alert
        # transitions land as ALERT instants in the tracer event stream
        self._slo = (SLOTracker(self.config.slo)
                     if self.config.slo else None)
        # fault layer: the injector exists only when a plan is
        # configured; the health tracker always exists (telemetry shape is
        # fixed) but records nothing unless the injector is active, so the
        # faults-off execute path stays byte-identical to the golden run
        plan = self.config.faults
        if plan is not None:
            plan.validate_banks(self.config.banks)
        self._injector = FaultInjector(plan) if plan is not None else None
        self._health = BankHealth(
            self.config.banks,
            active=self._injector is not None and self._injector.active)
        self._fault_agg = {"guard_failures": 0, "fallbacks": 0}
        # one persistent event-clock scheduler for the engine's lifetime;
        # the admission policy (if any) gates arrivals under overload
        self.scheduler = ContinuousScheduler(
            self.pool, policy=self.config.admission,
            on_event=(self._tracer.sched_event
                      if self._tracer is not None else None),
            health=self._health,
            recovery=(plan.recovery if plan is not None
                      else RecoveryPolicy()),
            prefetch=self._prefetch_tile)
        # serializes sessions/submits over the shared scheduler + telemetry
        # (the async front door feeds from its collector thread)
        self._lock = threading.RLock()
        # per-engine executor hit/miss/prewarm counts (the cache itself is
        # process-global; per-call warm flags keep attribution correct even
        # with several engines or threads sharing it)
        self._exec_stats = {"hits": 0, "misses": 0, "prewarmed": 0}
        # traffic-class -> set of tile signatures seen from that class's
        # sessions; begin(traffic_class=...) prewarms executors from it
        self._class_menus: dict[str, set] = {}
        self._cache: OrderedDict = OrderedDict()
        # bounded window for percentiles + running totals for all-time mean,
        # so a long-lived service does not accumulate one float per request
        self._latencies: deque = deque(maxlen=4096)
        self._lat_sum = 0.0
        self._lat_count = 0
        self._agg = {
            "requests": 0, "column_reads": 0, "cycles_exact": 0,
            "cycles_estimated": 0.0, "verify_failures": 0,
            "cache_hits": 0, "cache_misses": 0,
            "per_backend": {}, "per_op": {}, "modeled_hw": {},
            # mesh collective-round accounting (§IV manager rounds; the
            # mesh-side CR analogue): fixed shape, zeros off the mesh path.
            # Living inside _agg puts it under submit's all-or-nothing
            # snapshot/rollback for free.
            "collectives": {"rounds": 0, "planes": 0, "unfused_rounds": 0,
                            "prefetch_staged": 0, "prefetch_hits": 0},
        }

    # -------------------------------------------------------------- cache
    @staticmethod
    def _cache_key(req: SortRequest) -> tuple:
        """Result-cache identity: everything that determines the response
        except the request id — payload bytes, dtype, op, k, routing hint
        (hinted and policy-routed results must never cross)."""
        digest = hashlib.blake2b(np.ascontiguousarray(req.payload).tobytes(),
                                 digest_size=16).digest()
        return (req.op, req.k, req.backend, str(req.payload.dtype), req.n,
                digest)

    @staticmethod
    def _isolated_response(resp: SortResponse, **over) -> SortResponse:
        """Copy with private arrays — cache entries and served hits must not
        alias arrays a caller may mutate in place."""
        meta = over.pop("meta", None)
        return dataclasses.replace(
            resp,
            values=None if resp.values is None else resp.values.copy(),
            indices=None if resp.indices is None else resp.indices.copy(),
            meta=dict(resp.meta) if meta is None else meta, **over)

    # ------------------------------------------------------------------ core
    def _validate_batch(self, requests, prior_ids=frozenset()) -> None:
        """Ingress validation — before any batching — so bad input raises
        with the engine untouched and no co-batched work done."""
        ids = {req.request_id for req in requests}
        if len(ids) != len(requests) or ids & prior_ids:
            raise ValueError("duplicate request_id in batch; responses are "
                             "matched to requests by id")
        for req in requests:
            if req.backend is not None:
                be = self.policy.by_name.get(req.backend)
                if be is None:
                    raise KeyError(
                        f"request {req.request_id}: hinted backend "
                        f"{req.backend!r} not enabled; have "
                        f"{sorted(self.policy.by_name)}")
                if req.op not in be.ops:
                    raise ValueError(
                        f"request {req.request_id}: backend {req.backend!r} "
                        f"cannot serve op {req.op!r}")
            elif not any(req.op in b.ops for b in self.backends):
                raise ValueError(
                    f"request {req.request_id}: no enabled backend serves "
                    f"op {req.op!r}; have {sorted(self.policy.by_name)}")

    def _snapshot_state(self) -> dict:
        """Everything a failed batch must roll back (the executor cache is
        exempt by design: built launchers stay warm for retries).
        Sessions commit the result cache and latency window inline as tiles
        retire, so both are part of the snapshot."""
        return dict(
            agg=copy.deepcopy(self._agg),
            batch=copy.deepcopy(self.batcher.stats),
            sched=copy.deepcopy(self.scheduler.stats),
            vt=self.scheduler.vt,
            execs=dict(self._exec_stats),
            banks=[(b.tiles_served, b.rows_served, b.busy_cycles)
                   for b in self.pool.banks],
            cache=self._cache.copy(),
            lat=(list(self._latencies), self._lat_sum, self._lat_count),
            metrics=self._metrics.snapshot(),
            calib=self._calib.snapshot(),
            slo=None if self._slo is None else self._slo.snapshot(),
            # the scheduler's drain-rate ring feeds live retry-after hints
            # and telemetry, so it rolls back like every other signal
            drains=list(self.scheduler._drain_vts),
            # admission-policy state (watermark hysteresis, crossing count)
            # is telemetry-visible, so it rolls back with everything else
            policy=(None if self.scheduler.policy is None
                    else copy.deepcopy(vars(self.scheduler.policy))),
            # fault layer: quarantine/probation state, injector RNG + counts,
            # and the engine's guard/fallback counters — a rolled-back batch
            # must not leave banks quarantined or burn RNG draws
            fault=(dict(self._fault_agg), self._health.snapshot(),
                   None if self._injector is None
                   else self._injector.snapshot()),
        )

    def _restore_state(self, snap: dict) -> None:
        self._agg = snap["agg"]
        # stats objects restore IN PLACE: live sessions hold the engine's
        # BatcherStats by reference (shared aggregation), so reassigning the
        # attribute would silently orphan their telemetry
        for obj, saved in ((self.batcher.stats, snap["batch"]),
                           (self.scheduler.stats, snap["sched"])):
            for f in dataclasses.fields(saved):
                setattr(obj, f.name, getattr(saved, f.name))
        self.scheduler.vt = snap["vt"]
        self._exec_stats = snap["execs"]
        for bank, (t, r, c) in zip(self.pool.banks, snap["banks"]):
            bank.tiles_served, bank.rows_served, bank.busy_cycles = t, r, c
        self._cache = snap["cache"]
        lat, lat_sum, lat_count = snap["lat"]
        self._latencies = deque(lat, maxlen=self._latencies.maxlen)
        self._lat_sum, self._lat_count = lat_sum, lat_count
        # the tracer is deliberately NOT restored: flight-recorder semantics
        # — what the recorder saw, it keeps (aborted chains are finalized as
        # such in submit's except path)
        self._metrics.restore(snap["metrics"])
        self._calib.restore(snap["calib"])
        if snap["slo"] is not None:
            self._slo.restore(snap["slo"])
        self.scheduler._drain_vts = deque(
            snap["drains"], maxlen=self.scheduler._drain_vts.maxlen)
        if snap["policy"] is not None:
            # clear first: attributes the failed batch *created* (e.g. a
            # lazily-initialized counter) must not survive the rollback
            state = vars(self.scheduler.policy)
            state.clear()
            state.update(snap["policy"])
        fault_agg, health_snap, inj_snap = snap["fault"]
        self._fault_agg = fault_agg
        self._health.restore(health_snap)
        if inj_snap is not None:
            self._injector.restore(inj_snap)

    # ------------------------------------------------------------- sessions
    def begin(self, *, max_age_s: float | None = None, strict: bool = True,
              traffic_class: str | None = None) -> "SortSession":
        """Open a streaming session.

        ``max_age_s`` bounds how long a request may wait for co-bucketed
        neighbours (age-based bucket closing in :meth:`SortSession.poll`);
        ``strict=False`` isolates tile execution failures to their own
        requests instead of raising (the async front door's mode).

        ``traffic_class`` names the session's workload: the cost policy
        keeps a private measured-EMA prior for the class, and the executor
        cache is prewarmed here with every tile signature the class's past
        sessions produced, so the first tiles of this session land on warm
        launchers instead of paying a build."""
        if traffic_class is not None:
            self._prewarm(traffic_class)
        return SortSession(self, max_age_s=max_age_s, strict=strict,
                           traffic_class=traffic_class)

    def _note_signature(self, traffic_class: str | None, sig: tuple) -> None:
        """Record a tile signature in the class's prewarm menu."""
        if traffic_class is not None:
            self._class_menus.setdefault(traffic_class, set()).add(sig)

    def _prewarm(self, traffic_class: str) -> None:
        """Build launchers for the class's recorded signature menu."""
        with self._lock:
            for sig in sorted(self._class_menus.get(traffic_class, ()),
                              key=repr):
                op, b, n, k, hint = sig
                probe = Tile(op=op, data=np.zeros((b, n), np.uint32), k=k,
                             entries=[], pad_rows=b, hint=hint)
                try:
                    backend = self.policy.choose(probe,
                                                 traffic_class=traffic_class)
                except (KeyError, ValueError):
                    continue            # hint/op no longer servable: skip
                if backend.warm(b, n, op, k):
                    self._exec_stats["prewarmed"] += 1

    def submit(self, requests: list[SortRequest]) -> list[SortResponse]:
        """Serve a batch of requests; responses align with the input order.

        A thin feed-then-drain wrapper over one ephemeral session — ingress
        validation before any state changes, and all-or-nothing telemetry
        rollback if the batch fails (or is shed) mid-flight."""
        with self._lock:
            self._validate_batch(requests)
            snap = self._snapshot_state()
            session = self.begin()
            try:
                got = session.feed(requests)
                got += session.drain()
            except BaseException:
                self.scheduler.abort(session)
                if self._tracer is not None:
                    self._tracer.drop(session._outstanding, self._clock())
                self._restore_state(snap)
                raise
            by_id = {resp.request_id: resp for resp in got}
            return [by_id[req.request_id] for req in requests]

    def _fault_fallback(self, tile: Tile):
        """First enabled backend outside the fault-target set that serves
        the tile's op — the degradation ladder's software rung."""
        for be in self.backends:
            if be.name not in self._injector.plan.targets and \
                    tile.op in be.ops:
                return be
        return None

    def _prefetch_tile(self, tile: Tile) -> None:
        """Scheduler double-buffer hook: stage the next queued tile's device
        transfer on the backend that will (most likely) execute it, so the
        host->device copy overlaps the current tile's plane traversal.
        Best-effort — routing may differ at execute time, and a stale slot
        is simply unused; only backends with a ``prefetch`` method (the
        mesh backend) participate."""
        try:
            backend = self.policy.choose(tile)
        except (KeyError, ValueError):
            return                      # unroutable here; execute will raise
        pf = getattr(backend, "prefetch", None)
        if pf is not None and pf(tile):
            self._agg["collectives"]["prefetch_staged"] += 1

    def _execute(self, tile: Tile,
                 traffic_class: str | None = None) -> TileResult:
        backend = self.policy.choose(tile, traffic_class=traffic_class)
        inj = self._injector
        faulty = (inj is not None and inj.active
                  and backend.name in inj.plan.targets)
        if (faulty and tile.hint is None
                and tile.obs.get("fault_attempts", 0)
                >= inj.plan.recovery.escalate_after):
            # repeated in-memory failures: stop banging on the faulty
            # engine and serve this tile from a software fallback
            fb = self._fault_fallback(tile)
            if fb is not None:
                backend, faulty = fb, False
                self._fault_agg["fallbacks"] += 1
        t0 = self._clock()
        result = backend.run(tile)
        t1 = self._clock()
        if faulty:
            # injection + verification guard, in virtual time, before any
            # telemetry accounting: a faulted execution contributes nothing
            # (the scheduler released its banks with no credit) and the
            # FaultError takes the scheduler's retry path
            corrupted = inj.inject(tile, result,
                                   tile.obs.get("bank_ids", ()),
                                   self.config.bank_width)
            try:
                verify_tile_result(tile, result)
            except CorruptResultError as exc:
                self._fault_agg["guard_failures"] += 1
                exc.bank_ids = corrupted or tuple(
                    tile.obs.get("bank_ids", ()))
                raise
        result.meta["wall_s"] = t1 - t0
        warm = result.meta.get("exec_warm")     # None: backend has no cache
        if warm is not None:
            self._exec_stats["hits" if warm else "misses"] += 1
        # adaptive cost policy: measured wall-clock feeds the routing EMA —
        # but only warm executions.  A cold run's wall is dominated by the
        # one-time launcher build (the kernel compile, on the card);
        # recording it would poison the EMA (e.g. an exploration probe
        # measured at build cost would lose the race forever).  A skipped
        # cold probe leaves the EMA unset, so the next
        # tile probes again — now warm — and the race settles on real data.
        if warm is not False:
            self.policy.observe(backend.name, tile.op, tile.shape[1],
                                tile.shape[0], result.meta["wall_s"],
                                k=tile.k, traffic_class=traffic_class)
        # measured-vs-modeled calibration probe: wall seconds against the §V
        # cycle domain.  Same warm-only gate as the routing EMA — a cold
        # run's wall is build cost, not execution cost — and backends with
        # no modeled cycles (numpy oracle, radix plane reads) have no ratio.
        cycles_total = (int(result.cycles.sum())
                        if result.cycles is not None else None)
        modeled = result.modeled_cycles() or 0.0
        if warm is not False and modeled > 0:
            self._calib.record(backend.name, tile.shape[1],
                               result.meta["wall_s"], modeled)
        self._metrics.tile_executed(
            t1, occupancy=(sum(1 for b in self.pool.banks if b.loaded)
                           / len(self.pool.banks)))
        if self._tracer is not None:
            self._tracer.tile_executed(tile, backend.name, warm, t0, t1,
                                       cycles_total, result.estimated_cycles)
        pb = self._agg["per_backend"].setdefault(
            backend.name, {"tiles": 0, "requests": 0, "rows": 0,
                           "column_reads": 0, "wall_s": 0.0})
        pb["tiles"] += 1
        pb["requests"] += len(tile.entries)
        pb["rows"] += tile.shape[0]
        pb["wall_s"] += result.meta["wall_s"]
        if result.column_reads is not None:
            pb["column_reads"] += int(result.column_reads.sum())
            self._agg["column_reads"] += int(result.column_reads.sum())
        if result.cycles is not None:
            self._agg["cycles_exact"] += int(result.cycles.sum())
        if result.estimated_cycles is not None:
            self._agg["cycles_estimated"] += float(result.estimated_cycles)
        # mesh collective rounds (zero off the mesh path): issued vs the
        # one-psum-per-plane baseline vs planes traversed — the mesh CR
        coll = self._agg["collectives"]
        coll["rounds"] += int(result.meta.get("coll_rounds", 0))
        coll["planes"] += int(result.meta.get("coll_planes", 0))
        coll["unfused_rounds"] += int(result.meta.get("coll_unfused_rounds",
                                                      0))
        if result.meta.get("prefetch_hit"):
            coll["prefetch_hits"] += 1
        n = tile.shape[1]
        if str(n) not in self._agg["modeled_hw"]:   # compute once per width
            self._agg["modeled_hw"][str(n)] = \
                self.policy.modeled_throughput(n, self.config.state_k)
        return result

    def _scatter(self, tile: Tile, result: TileResult, lat_fn):
        """Yield one response per tile entry; ``lat_fn(req)`` supplies the
        per-request latency (constant on the batch path, feed-to-retire on
        the streaming path)."""
        for req, row in tile.entries:
            out = req.out_len
            vals_u = np.asarray(result.values[row, :out])
            idxs = (np.asarray(result.indices[row, :out], np.int32)
                    if result.indices is not None else None)
            meta = {"pad_cols": tile.shape[1] - req.n}
            if self.config.verify:
                ref_v, ref_i = solve_numpy(
                    req.op, tile.data[row, :], req.k)
                ok = np.array_equal(vals_u, ref_v[:out])
                if ok and req.op in ("argsort", "topk", "kmin"):
                    ok = idxs is not None and np.array_equal(idxs, ref_i[:out])
                if not ok:
                    self._agg["verify_failures"] += 1
                    meta["verify_failed"] = True   # also bars it from cache
            yield SortResponse(
                request_id=req.request_id,
                op=req.op,
                values=(None if req.op == "argsort"
                        else decode_values(vals_u, req.payload.dtype)),
                indices=None if req.op == "sort" else idxs,
                backend=result.backend,
                bucket_shape=tile.shape,
                latency_s=lat_fn(req),
                column_reads=(int(result.column_reads[row])
                              if result.column_reads is not None else None),
                cycles=(int(result.cycles[row])
                        if result.cycles is not None else None),
                meta=meta,
            )

    # ------------------------------------------------------------- telemetry
    # clamp bounds for the live retry-after hint: never 0 (callers must
    # actually back off), never unbounded (a cold engine with an empty
    # window must not tell callers to go away for minutes)
    _RETRY_AFTER_MIN_S = 1e-3
    _RETRY_AFTER_MAX_S = 5.0
    _RETRY_AFTER_DEFAULT_S = 0.02

    def retry_after_s(self, now: float | None = None) -> float:
        """Live back-off hint: the time the current queue needs to drain.

        Derived from the windowed drain rate — ``(queue_depth + 1) /
        window.tiles_per_s`` (the +1 is the caller's own tile) — falling
        back to the measured mean wall per tile spread over the banks when
        the window is empty, and to a small constant on a cold engine.
        Clamped to [1 ms, 5 s]; deterministic under a fake clock."""
        with self._lock:
            return self._retry_after_at(
                self._clock() if now is None else now)

    def _retry_after_at(self, now: float) -> float:
        depth = self.scheduler.queue_depth()
        tiles_per_s = self._metrics.tiles.rate(now)
        if tiles_per_s > 0:
            hint = (depth + 1.0) / tiles_per_s
        else:
            pb = self._agg["per_backend"]
            tiles = sum(v["tiles"] for v in pb.values())
            wall = sum(v["wall_s"] for v in pb.values())
            if tiles > 0 and wall > 0:
                hint = ((depth + 1.0) * (wall / tiles)
                        / len(self.pool.banks))
            else:
                hint = self._RETRY_AFTER_DEFAULT_S
        return min(max(hint, self._RETRY_AFTER_MIN_S),
                   self._RETRY_AFTER_MAX_S)

    def _executor_cache_stats(self) -> dict:
        hits, misses = self._exec_stats["hits"], self._exec_stats["misses"]
        # the persistent split is process-global (like "size"): library
        # lookups in the compile-cache directory; 0 while none is set
        p_hits, p_misses = EXECUTOR_CACHE.persistent_counters()
        return {"hits": hits, "misses": misses,
                "prewarmed": self._exec_stats["prewarmed"],
                "hit_rate": hits / max(1, hits + misses),
                "size": EXECUTOR_CACHE.counters()[2],
                "persistent_hits": p_hits,
                "persistent_misses": p_misses}

    def telemetry(self) -> dict:
        now = self._clock()
        lat = np.asarray(self._latencies) if self._latencies else np.zeros(1)
        bs = self.batcher.stats
        cache_hit_rate = (self._agg["cache_hits"] /
                          max(1, self._agg["cache_hits"] +
                              self._agg["cache_misses"]))
        return {
            "requests": self._agg["requests"],
            "latency_s": {
                # both means, under distinct keys: "mean" is the all-time
                # running mean (running totals, unbounded history), while
                # "mean_windowed" averages the same bounded 4096-request
                # window the p50/p95/max quantiles are computed from
                "mean": (self._lat_sum / self._lat_count
                         if self._lat_count else 0.0),
                "mean_windowed": float(lat.mean()),
                "p50": float(np.percentile(lat, 50)),
                "p95": float(np.percentile(lat, 95)),
                "max": float(lat.max()),
            },
            "column_reads": self._agg["column_reads"],
            "cycles_exact": self._agg["cycles_exact"],
            "cycles_estimated": self._agg["cycles_estimated"],
            "verify_failures": self._agg["verify_failures"],
            # copies: exported telemetry must not alias internal counters
            "per_backend": copy.deepcopy(self._agg["per_backend"]),
            "per_op": dict(self._agg["per_op"]),
            "cache": {
                "hits": self._agg["cache_hits"],
                "misses": self._agg["cache_misses"],
                "hit_rate": cache_hit_rate,
                "size": len(self._cache),
                "capacity": self.config.cache_size,
            },
            # launcher cache (process-global; deltas since this engine was
            # built): warm tiles skip the launcher build
            "executor_cache": self._executor_cache_stats(),
            "batcher": {
                "tiles": bs.tiles,
                "requests": bs.requests,
                "pad_rows": bs.pad_rows,
                "pad_col_frac": bs.pad_col_frac,
                "bucket_hit_rate": bs.hit_rate,
                # result-cache hit rate lives next to the bucket hit rate:
                # both measure how much of the stream re-used earlier work
                "cache_hit_rate": cache_hit_rate,
                "distinct_signatures": len(bs.signatures),
            },
            "scheduler": self.scheduler.telemetry(),
            # §IV manager rounds on the mesh path (zeros elsewhere):
            # round_cr is the fused-round reduction factor vs the
            # one-psum-per-plane baseline — the mesh-side CR analogue
            "collectives": self._collectives_section(),
            "modeled_hw_throughput_num_per_s": dict(self._agg["modeled_hw"]),
            # sliding-window live signals (the fleet router's placement
            # input) and the per-(backend, width) measured-vs-modeled table
            "window": {
                **self._metrics.window(now, self.scheduler.queue_depth()),
                "retry_after_s": self._retry_after_at(now),
            },
            "calibration": self._calib.table(),
            # per-class SLO burn rates + alert state ({} unless configured
            # via EngineConfig(slo=...)); read-only — alert transitions
            # happen at event time, never at render
            "slo": (self._slo.section(now)
                    if self._slo is not None else {}),
            # fault injection + recovery: fixed shape whether or not
            # a FaultPlan is configured, every bank always present under
            # per_bank — zeros and "healthy" on a faults-off engine
            "fault": self._fault_section(),
        }

    def _collectives_section(self) -> dict:
        c = self._agg["collectives"]
        return {**c, "round_cr": (c["unfused_rounds"] / c["rounds"]
                                  if c["rounds"] else 0.0)}

    def _fault_section(self) -> dict:
        inj = self._injector
        ss = self.scheduler.stats
        return {
            "enabled": bool(inj is not None and inj.active),
            "injected": (dict(inj.injected) if inj is not None else
                         {"transient": 0, "stuck": 0, "dead": 0, "slow": 0}),
            "guard_failures": self._fault_agg["guard_failures"],
            "fallbacks": self._fault_agg["fallbacks"],
            "failures": ss.fault_failures,
            "retries": ss.retries,
            "exhausted": ss.fault_exhausted,
            **self._health.section(),
        }

    def dump_telemetry(self, path: str) -> dict:
        telem = self.telemetry()
        with open(path, "w") as f:
            json.dump(telem, f, indent=2, sort_keys=True)
        return telem

    def telemetry_snapshot(self, source: str | None = None) -> TelemetrySnapshot:
        """Raw-accumulator snapshot for cross-engine aggregation
        (:mod:`repro_torch.obs.aggregate`) — counters, timestamped gauges, log2
        histogram buckets, windowed events, calibration sums, SLO state.
        Taken under the engine lock: one consistent instant."""
        with self._lock:
            return capture(self, source=source)

    def dump_snapshot(self, path: str,
                      source: str | None = None) -> TelemetrySnapshot:
        """Write the mergeable telemetry snapshot as JSON (the per-replica
        artifact a fleet view folds together)."""
        snap = self.telemetry_snapshot(source=source)
        snap.dump(path)
        return snap

    def dump_metrics(self, path: str | None = None,
                     source: str | None = None) -> str:
        """Render current telemetry as OpenMetrics/Prometheus text
        exposition; write it to ``path`` when given.  The render works
        from the raw snapshot (no percentile sorts, no deep copies), so
        it costs no more than a ``telemetry()`` call — gated by the
        export-overhead row in ``benchmarks/streaming_bench.py``."""
        text = render_openmetrics(self.telemetry_snapshot(source=source))
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    # ----------------------------------------------------------- warm state
    def export_warm_state(self) -> dict:
        """The raw warm-state blocks — per-traffic-class tile-signature
        menus, measured :class:`CostPolicy` EMAs (class rows included),
        and calibration profile rows — taken under the engine lock.  The
        blocks carry only JSON-native values, sorted deterministically.
        :func:`repro_torch.sortserve.fleet.save_warm_state` wraps this in
        the versioned artifact envelope."""
        with self._lock:
            menus = {cls: [list(sig) for sig in sorted(sigs, key=repr)]
                     for cls, sigs in sorted(self._class_menus.items())}
            return {"menus": menus,
                    "priors": self.policy.export_priors(include_classes=True),
                    "calibration": self._calib.profile_rows()}

    def apply_warm_state(self, state: dict) -> dict:
        """Seed this engine from warm-state blocks (see
        :meth:`export_warm_state`): union the signature menus into the
        class prewarm menus, seed cost-EMA priors (live measurements
        outrank the artifact), seed calibration cells, then prewarm the
        executor cache for every loaded class.  Nothing here executes a
        tile — the engine takes its first request with warmed executors
        and warmed priors but zero cold-path EMA observations.  Returns
        ``{classes, signatures, priors, calibration, prewarmed}`` counts."""
        with self._lock:
            menus = state.get("menus", {})
            signatures = 0
            for cls, menu in sorted(menus.items()):
                dest = self._class_menus.setdefault(str(cls), set())
                for op, b, n, k, hint in menu:
                    sig = (str(op), int(b), int(n),
                           None if k is None else int(k),
                           None if hint is None else str(hint))
                    if sig not in dest:
                        dest.add(sig)
                        signatures += 1
            n_priors = self.policy.load_priors(state.get("priors", []))
            n_calib = self._calib.seed_rows(state.get("calibration", []))
            before = self._exec_stats["prewarmed"]
        for cls in sorted(menus):
            self._prewarm(str(cls))
        with self._lock:
            prewarmed = self._exec_stats["prewarmed"] - before
        return {"classes": len(menus), "signatures": signatures,
                "priors": n_priors, "calibration": n_calib,
                "prewarmed": prewarmed}

    def dump_trace(self, path: str) -> dict:
        """Export the flight recorder as Chrome trace-event JSON (viewable
        at https://ui.perfetto.dev): the wall-clock request spans and the
        virtual-time bank/scheduler tracks of
        :meth:`repro_torch.obs.Tracer.export`."""
        if self._tracer is None:
            raise RuntimeError(
                "no tracer configured; build the engine with "
                "EngineConfig(tracer=repro_torch.obs.Tracer())")
        with self._lock:
            return self._tracer.dump(path,
                                     bank_labels=self.pool.bank_labels())


class SortSession:
    """One streaming request stream over the engine's continuous core.

    Open with :meth:`SortServeEngine.begin`.  The session owns its buckets
    (a private :class:`Batcher` aggregating into the engine's stats) but
    shares the engine's bank pool, event clock, result cache, and policy —
    several sessions admit tiles into the same pool concurrently, exactly
    like independent datasets occupying §IV banks.

    Delivery contract: every fed request's response is returned **exactly
    once**, by whichever of :meth:`feed` / :meth:`poll` / :meth:`drain`
    observes its tile retire.  ``feed`` dispatches buckets the moment they
    reach ``tile_rows`` (size closure); ``poll`` additionally closes buckets
    whose oldest request has waited ``max_age_s`` (age closure); ``drain``
    closes everything.  With ``strict=False`` a tile execution failure is
    isolated: the tile's requests surface through :meth:`take_failures`
    instead of raising (the async front door's mode).

    Per-request latency is feed-to-retire on the engine's injectable clock;
    :meth:`telemetry` reports the session's own latency quantiles plus its
    slice of the event-clock admission stats.
    """

    def __init__(self, engine: SortServeEngine, *,
                 max_age_s: float | None = None, strict: bool = True,
                 traffic_class: str | None = None):
        self.engine = engine
        self.max_age_s = max_age_s
        self.strict = strict
        self.traffic_class = traffic_class
        self._batcher = Batcher(engine.config.tile_rows,
                                engine.config.min_bucket,
                                stats=engine.batcher.stats)
        # per-request state lives only while a request is in flight: every
        # map/set below is pruned at retire/failure, so a long-lived
        # streaming session (the async front door) stays O(in-flight), and
        # the latency window is bounded like the engine's
        self._fed_ids: set[int] = set()
        self._outstanding: set[int] = set()
        self._keys: dict[int, tuple] = {}       # rid -> result-cache key
        self._t_fed: dict[int, float] = {}
        self._out: list[SortResponse] = []      # completed, undelivered
        self._failures: list[tuple[SortRequest, BaseException, int]] = []
        self._lat: deque = deque(maxlen=4096)
        self._stats = {"requests": 0, "completed": 0, "failed": 0,
                       "shed": 0, "cache_hits": 0, "tiles": 0}
        self._sched0 = copy.deepcopy(engine.scheduler.stats)

    # -------------------------------------------------------------- ingress
    def feed(self, requests: list[SortRequest], *, flush: bool = False,
             isolate: bool = False,
             now: float | None = None) -> list[SortResponse]:
        """Accept requests into the stream; returns whatever completed.

        Validation (including request-id uniqueness among the session's
        in-flight requests) happens before any state changes, so a bad
        request raises with nothing half-fed.  Cache hits complete
        immediately; misses bucket, and buckets that reach ``tile_rows``
        dispatch into the event clock right away.  ``flush=True``
        force-closes every open bucket after this feed; ``isolate=True``
        bypasses the shared buckets entirely and gives each fed request
        its own tile (the front door's failure-isolation retry — other
        callers' open buckets are untouched)."""
        e = self.engine
        with e._lock:
            now = e._clock() if now is None else now
            e._validate_batch(requests, prior_ids=self._outstanding)
            use_cache = e.config.cache_size > 0
            tracer = e._tracer
            solo: list[SortRequest] = []
            for req in requests:
                rid = req.request_id
                self._stats["requests"] += 1
                key = e._cache_key(req) if use_cache else None
                entry = e._cache.get(key) if use_cache else None
                if entry is not None:
                    e._cache.move_to_end(key)
                    e._agg["cache_hits"] += 1
                    self._stats["cache_hits"] += 1
                    if tracer is not None:
                        tracer.request_cache_hit(rid, req.op, req.n,
                                                 self.traffic_class, now)
                    self._record(e._isolated_response(
                        entry, request_id=rid, latency_s=0.0,
                        meta={**entry.meta, "cache_hit": True}), 0.0, now)
                    continue
                if use_cache:
                    e._agg["cache_misses"] += 1
                    self._keys[rid] = key
                e._note_signature(self.traffic_class,
                                  self._batcher.signature_of(req))
                self._t_fed[rid] = now
                self._outstanding.add(rid)
                if tracer is not None:
                    tracer.request_feed(rid, req.op, req.n,
                                        self.traffic_class, now)
                if isolate:
                    solo.append(req)
                else:
                    self._batcher.add(req, now)
            tiles = []
            for req in solo:                  # one private tile per request
                lone = Batcher(e.config.tile_rows, e.config.min_bucket,
                               stats=e.batcher.stats)
                lone.add(req, now)
                tiles += lone.flush()
            tiles += (self._batcher.flush() if flush
                      else self._batcher.take_ready(now, self.max_age_s))
            self._dispatch(tiles)
            return self._take()

    def poll(self, now: float | None = None) -> list[SortResponse]:
        """Close aged buckets, pump the event clock, return completions."""
        e = self.engine
        with e._lock:
            now = e._clock() if now is None else now
            self._dispatch(self._batcher.take_ready(now, self.max_age_s))
            return self._take()

    def drain(self) -> list[SortResponse]:
        """Close every open bucket and return all remaining responses."""
        e = self.engine
        with e._lock:
            self._dispatch(self._batcher.flush())
            if self.strict and self._outstanding:
                raise RuntimeError(
                    f"{len(self._outstanding)} requests vanished without "
                    "retiring — scheduler invariant broken")
            return self._take()

    def take_failures(self) -> list[tuple[SortRequest, BaseException, int]]:
        """Isolated tile failures and admission sheds: one entry per failed
        request as ``(request, exception, co_batched_count)``; a shed
        request's exception is a
        :class:`~repro_torch.sortserve.scheduler.ShedError`."""
        with self.engine._lock:
            out, self._failures = self._failures, []
            return out

    def next_deadline(self) -> float | None:
        """Clock instant the oldest open bucket ages out (None: no bound)."""
        if self.max_age_s is None:
            return None
        with self.engine._lock:
            return self._batcher.oldest_deadline(self.max_age_s)

    # ------------------------------------------------------------ internals
    def _dispatch(self, tiles: list[Tile]) -> None:
        e = self.engine
        if tiles:
            self._stats["tiles"] += len(tiles)
            tracer = e._tracer
            if tracer is not None:
                now = e._clock()
                for tile in tiles:
                    rec = tracer.tile_dispatched(tile, now)
                    for req, _ in tile.entries:
                        tracer.request_dispatched(req.request_id, rec, now)
            e.scheduler.feed(
                tiles,
                lambda tile: e._execute(tile,
                                        traffic_class=self.traffic_class),
                sink=self._on_tile, strict=self.strict, owner=self)
            e.scheduler.pump()

    def _on_tile(self, tile: Tile, result, exc) -> None:
        e = self.engine
        if exc is not None:
            now = e._clock()
            shed = isinstance(exc, ShedError)
            for req, _ in tile.entries:
                # a failed (or shed) request leaves the stream entirely —
                # the front door may legitimately re-feed it (isolation
                # retry / caller back-off), so every trace of it is pruned
                self._outstanding.discard(req.request_id)
                self._t_fed.pop(req.request_id, None)
                self._keys.pop(req.request_id, None)
                self._stats["shed" if shed else "failed"] += 1
                self._failures.append((req, exc, len(tile.entries)))
                e._metrics.request_rejected(now, shed=shed)
                if shed and e._slo is not None:
                    e._slo.record_shed(now, self.traffic_class,
                                       vt=e.scheduler.vt, tracer=e._tracer)
                if e._tracer is not None:
                    e._tracer.request_failed(req.request_id, now,
                                             "shed" if shed else "failed")
            return
        now = e._clock()
        use_cache = e.config.cache_size > 0
        tracer = e._tracer
        for resp in e._scatter(
                tile, result,
                lambda req: now - self._t_fed[req.request_id]):
            rid = resp.request_id
            self._outstanding.discard(rid)
            if use_cache and not resp.meta.get("verify_failed"):
                key = self._keys.pop(rid, None)
                if key is not None:
                    e._cache[key] = e._isolated_response(resp)
            if tracer is not None:
                tracer.request_done(rid, now, resp.latency_s)
            self._record(resp, resp.latency_s, now)
        for req, _ in tile.entries:               # retired: prune stamps
            self._t_fed.pop(req.request_id, None)
            self._keys.pop(req.request_id, None)
        if use_cache:
            while len(e._cache) > e.config.cache_size:
                e._cache.popitem(last=False)          # evict LRU

    def _record(self, resp: SortResponse, latency: float,
                now: float | None = None) -> None:
        e = self.engine
        self._stats["completed"] += 1
        e._agg["requests"] += 1
        per_op = e._agg["per_op"]
        per_op[resp.op] = per_op.get(resp.op, 0) + 1
        e._latencies.append(latency)
        e._lat_sum += latency
        e._lat_count += 1
        self._lat.append(latency)
        self._out.append(resp)
        now = e._clock() if now is None else now
        e._metrics.request_done(now, latency)
        if e._slo is not None:
            e._slo.record_done(now, self.traffic_class, latency,
                               vt=e.scheduler.vt, tracer=e._tracer)

    def _take(self) -> list[SortResponse]:
        out, self._out = self._out, []
        return out

    # ------------------------------------------------------------ telemetry
    def telemetry(self) -> dict:
        """This session's slice: request/latency stats plus the event-clock
        deltas (admissions, queue wait, mid-wave grants) since begin()."""
        e = self.engine
        with e._lock:
            lat = np.asarray(self._lat) if self._lat else np.zeros(1)
            cur, base = e.scheduler.stats, self._sched0

            def delta(name: str):
                return getattr(cur, name, 0) - getattr(base, name, 0)

            return {
                **self._stats,
                "traffic_class": self.traffic_class,
                "open_bucket_rows": self._batcher.pending(),
                "in_flight": len(self._outstanding),
                "latency_s": {
                    "mean": float(lat.mean()),
                    "p50": float(np.percentile(lat, 50)),
                    "p95": float(np.percentile(lat, 95)),
                    "max": float(lat.max()),
                },
                # pool-wide event-clock deltas while this session ran (other
                # sessions' admissions included — banks are shared, as §IV
                # banks are)
                "scheduler_delta": {
                    "tiles": delta("tiles"),
                    "drains": delta("drains"),
                    "mid_wave_admissions": delta("mid_wave_admissions"),
                    "admissions": delta("admissions"),
                    "arrivals": delta("arrivals"),
                    "events": delta("events"),
                    "deferred": delta("deferred"),
                    "shed": delta("shed"),
                    "queue_wait_vt": delta("queue_wait_vt"),
                    "busy_bank_vt": delta("busy_bank_vt"),
                },
            }


@dataclass(frozen=True)
class BackoffPolicy:
    """Deterministic capped exponential backoff for shed-request resubmits.

    The front door's client-side retry policy: a request shed by the
    engine's admission policy is automatically resubmitted ``delay_s(n)``
    seconds later (on the front door's injectable clock), at most
    ``max_attempts`` times, before its future finally resolves with
    :class:`RetryAfter`.  ``delay_s`` is ``min(base_s * factor**(n-1),
    cap_s)`` — no jitter, so a fake-clock test replays the identical
    schedule.  This replaces ad-hoc single-retry isolation as the front
    door's only recovery path: isolation handles co-bucketed execution
    failures, backoff handles overload sheds."""

    base_s: float = 0.01
    factor: float = 2.0
    cap_s: float = 1.0
    max_attempts: int = 3

    def __post_init__(self):
        if self.base_s <= 0 or self.cap_s <= 0 or self.factor < 1.0:
            raise ValueError("base_s/cap_s must be positive, factor >= 1")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def delay_s(self, attempt: int) -> float:
        """Backoff before resubmission number ``attempt`` (1-based)."""
        return min(self.base_s * self.factor ** (max(attempt, 1) - 1),
                   self.cap_s)


class AsyncSortServe:
    """Streaming async front door: futures in, continuous admission out.

    The collector thread feeds one long-lived :class:`SortSession` directly
    — there is **no global flush barrier** anywhere on the path.  A request
    waits only for its own bucket to close (``tile_rows`` co-shaped
    neighbours, or ``max_wait_ms`` of age, whichever first); its tile is
    admitted into the bank pool the moment banks drain, and its future
    resolves when that tile retires — co-arriving requests of other shapes
    neither delay it nor wait for it.

    ``max_batch`` bounds how many queued requests the collector ingests per
    iteration before pumping completions.  ``clock`` (default: the engine's
    clock) drives bucket ages and latency stamps, so streaming behaviour is
    reproducible in tests without sleeps.

    Tile execution failures are isolated (the session runs ``strict=False``):
    a request co-bucketed with an offender is retried once in its own tile,
    so only the true offender's future errors — the same neighbour
    protection the micro-batching front door had.

    **Backpressure**: the front door is bounded instead of
    unbounded-queueing.  ``max_inflight`` caps accepted-but-unresolved
    futures — a submit over the cap fails immediately with
    :class:`RetryAfter` (the inflight semaphore, without blocking the
    caller) — and a request shed by the engine's admission policy under
    overload resolves its future with :class:`RetryAfter` as well (no
    isolation retry: re-feeding a shed request would just shed it again).
    Both rejections are deterministic; a request is never silently dropped.
    ``traffic_class`` is forwarded to the underlying session (per-class
    cost priors + executor prewarming at construction).
    """

    _STOP = object()

    def __init__(self, engine: SortServeEngine, max_batch: int = 64,
                 max_wait_ms: float = 2.0, *, clock=None,
                 max_inflight: int | None = None,
                 traffic_class: str | None = None,
                 retry_policy: BackoffPolicy | None = None):
        if max_inflight is not None and max_inflight < 1:
            raise ValueError("max_inflight must be >= 1 (or None: unbounded)")
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.max_inflight = max_inflight
        self.retry_policy = retry_policy
        self._clock = clock if clock is not None else engine._clock
        self.session = engine.begin(max_age_s=self.max_wait_s, strict=False,
                                    traffic_class=traffic_class)
        self._q: queue.Queue = queue.Queue()
        self._pending: dict[int, tuple[SortRequest, Future]] = {}
        self._retried: set[int] = set()
        # (due_t, seq, request, future, pending RetryAfter): shed requests
        # awaiting their backoff resubmission; attempts counted per rid
        self._retry_heap: list = []
        self._retry_seq = 0
        self._retry_attempts: dict[int, int] = {}
        self._lock = threading.Lock()
        self._inflight = 0              # accepted futures not yet resolved
        self.rejected = 0               # submits refused at the inflight cap
        self._closed = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request: SortRequest) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("sort service closed")
            if (self.max_inflight is not None
                    and self._inflight >= self.max_inflight):
                # the bounded-inflight semaphore: refuse deterministically
                # instead of growing the queue/heap under overload; the
                # hint is live — queue depth over the windowed drain rate
                self.rejected += 1
                self._resolve(fut, exc=RetryAfter(
                    f"{self._inflight} requests in flight >= max_inflight="
                    f"{self.max_inflight}; retry later",
                    retry_after_s=self.engine.retry_after_s(self._clock())))
                return fut
            self._inflight += 1
            # stamp arrival here, on the caller's side of the queue: bucket
            # age and latency count from submission, not collector pickup
            self._q.put((request, fut, self._clock()))
        return fut

    def metrics(self) -> str:
        """The front door's pull endpoint: current telemetry rendered as
        OpenMetrics text exposition (what a scraper would GET)."""
        return self.engine.dump_metrics()

    def close(self) -> None:
        """Serve everything already accepted, then stop the collector.

        Idempotent.  The lock orders every ``submit`` before the STOP
        marker (or fails it), and ``_loop`` feeds the queue tail behind
        STOP and drains the session before exiting — so every accepted
        future is resolved and ``submit`` after ``close`` raises instead
        of enqueueing."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(self._STOP)
        self._thread.join()

    @staticmethod
    def _resolve(fut: Future, resp=None, exc=None) -> None:
        """Set a future's outcome, tolerating caller-side cancellation —
        an InvalidStateError here must not kill the collector thread."""
        try:
            fut.set_exception(exc) if exc is not None else fut.set_result(resp)
        except InvalidStateError:
            pass

    def _finish(self, fut: Future, resp=None, exc=None) -> None:
        """Resolve an *accepted* future and release its inflight slot."""
        self._resolve(fut, resp, exc)
        with self._lock:
            self._inflight -= 1

    # --------------------------------------------------------- stream plumbing
    def _feed_one(self, req: SortRequest, fut: Future,
                  at: float | None = None, isolate: bool = False) -> None:
        """Feed one request into the session; a validation error fails its
        future alone (the session state is untouched on validation)."""
        if req.request_id in self._pending:
            # fail the newcomer directly: registering it would orphan the
            # in-flight request's future under the same id
            self._finish(fut, exc=ValueError(
                f"request_id {req.request_id} already in flight"))
            return
        self._pending[req.request_id] = (req, fut)
        try:
            done = self.session.feed(
                [req], isolate=isolate,
                now=self._clock() if at is None else at)
        except Exception as exc:
            self._pending.pop(req.request_id, None)
            self._finish(fut, exc=exc)
            return
        self._deliver(done)

    def _deliver(self, responses: list[SortResponse]) -> None:
        for resp in responses:
            item = self._pending.pop(resp.request_id, None)
            if item is not None:
                self._retried.discard(resp.request_id)
                self._retry_attempts.pop(resp.request_id, None)
                self._finish(item[1], resp)
        for req, exc, co_batched in self.session.take_failures():
            rid = req.request_id
            item = self._pending.get(rid)
            if item is None:
                continue
            if isinstance(exc, ShedError):
                # admission-policy backpressure: deterministic caller-visible
                # deferral — an immediate retry would re-enter the overloaded
                # queue.  The hint is the engine's live drain-rate estimate
                # of how long the queue ahead needs, not a fixed constant
                self._pending.pop(rid)
                self._retried.discard(rid)
                retry = RetryAfter(
                    str(exc),
                    retry_after_s=self.engine.retry_after_s(self._clock()))
                retry.__cause__ = exc
                pol = self.retry_policy
                attempts = self._retry_attempts.get(rid, 0)
                if pol is not None and attempts < pol.max_attempts:
                    # client-side backoff: resubmit after a deterministic
                    # capped-exponential delay instead of failing the future
                    self._retry_attempts[rid] = attempts + 1
                    self._retry_seq += 1
                    heapq.heappush(self._retry_heap, (
                        self._clock() + pol.delay_s(attempts + 1),
                        self._retry_seq, req, item[1], retry))
                else:
                    self._retry_attempts.pop(rid, None)
                    self._finish(item[1], exc=retry)
            elif co_batched > 1 and rid not in self._retried:
                # the failure may belong to a co-bucketed neighbour: retry
                # in a private tile (isolate=True) so only the true
                # offender's future errors and no open bucket closes early
                self._retried.add(rid)
                self._pending.pop(rid)
                self._feed_one(req, item[1], isolate=True)
            else:
                self._pending.pop(rid)
                self._retried.discard(rid)
                self._retry_attempts.pop(rid, None)
                self._finish(item[1], exc=exc)

    def _flush_retries(self) -> None:
        """Resubmit every backoff whose due instant has passed."""
        now = self._clock()
        while self._retry_heap and self._retry_heap[0][0] <= now:
            _, _, req, fut, _ = heapq.heappop(self._retry_heap)
            if not fut.cancelled():
                self._feed_one(req, fut)
            else:
                with self._lock:
                    self._inflight -= 1
        # a resubmission may itself shed and re-enter the heap above; the
        # next loop iteration's deadline accounts for it

    def _next_retry_t(self) -> float | None:
        return self._retry_heap[0][0] if self._retry_heap else None

    def _pump(self) -> None:
        self._flush_retries()
        self._deliver(self.session.poll(self._clock()))

    def _loop(self) -> None:
        stop = False
        while not stop:
            deadline = self.session.next_deadline()
            retry_t = self._next_retry_t()
            if retry_t is not None:
                deadline = retry_t if deadline is None \
                    else min(deadline, retry_t)
            if deadline is None:
                timeout = None                 # nothing aging: block for work
            else:
                # a fake clock does not advance while we block, so floor the
                # real wait instead of busy-spinning until the test ticks it
                timeout = max(min(deadline - self._clock(), self.max_wait_s),
                              1e-3)
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                item = None
            ingested = 0
            while item is not None:
                if item is self._STOP:
                    stop = True
                    break
                req, fut, at = item
                if not fut.cancelled():
                    self._feed_one(req, fut, at)
                else:
                    with self._lock:      # caller bailed: free its slot
                        self._inflight -= 1
                ingested += 1
                if ingested >= self.max_batch:
                    break
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
            self._pump()
        # STOP seen: feed whatever was already queued behind it, then drain
        # the session so no accepted request leaves its future unresolved
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._STOP:
                continue
            req, fut, at = item
            if not fut.cancelled():
                self._feed_one(req, fut, at)
            else:
                with self._lock:
                    self._inflight -= 1
        self._deliver(self.session.drain())
        # backoffs still pending at close resolve with their RetryAfter —
        # the service is going away, so "come back later" is the truth
        while self._retry_heap:
            _, _, _, fut, retry = heapq.heappop(self._retry_heap)
            self._finish(fut, exc=retry)
        self._retry_attempts.clear()
        for rid, (req, fut) in list(self._pending.items()):
            self._pending.pop(rid)
            self._finish(fut, exc=RuntimeError(
                f"request {rid} left unserved at close"))


# Reference fields that select between Pallas and jnp: the port selects
# kernel or plain torch by the device instead.
_PALLAS_ONLY = ("use_pallas", "interpret")
# Reference fields that hold reference-package objects.
_OBJECT_FIELDS = ("admission", "tracer", "slo", "faults")


def config_from_reference(d: dict, *, device="cuda") -> EngineConfig:
    """An :class:`EngineConfig` from ``dataclasses.asdict`` of the
    reference's ``EngineConfig``.

    Raises on what this slice does not support: unknown fields, a set
    ``use_pallas``/``interpret`` (Pallas switches), objects of the
    reference package in ``admission``/``tracer``/``slo``/``faults`` (build
    the port's own and pass them to :class:`EngineConfig`).  ``mesh``,
    ``mesh_hosts``, ``fuse`` and ``compile_cache`` (a directory, here of
    kernel libraries) cross as they are."""
    d = dict(d)
    for name in _PALLAS_ONLY:
        value = d.pop(name, None)
        if value is not None:
            raise ValueError(f"{name}={value!r} selects Pallas vs jnp; the "
                             "port selects by device")
    for name in _OBJECT_FIELDS:
        if d.get(name) is not None:
            raise ValueError(f"{name} holds a reference-package object; "
                             "pass the port's own to EngineConfig")
    known = {f.name for f in dataclasses.fields(EngineConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"unknown EngineConfig fields {unknown}")
    d["backends"] = tuple(d.get("backends", EngineConfig.backends))
    d["device"] = device
    return EngineConfig(**d)
