"""Bank-pool scheduler modeled on the paper's §IV multi-bank manager.

The hardware manager owns C memristive banks; a length-N dataset wider than
one bank is sharded over several, and the manager OR-combines the per-bank
predicates (saw-a-1 / saw-a-0, CR/SL enables) so the group behaves as one
sorter.  The serving analogue implemented here:

  * a fixed pool of :class:`LogicalBank` objects, each with ``bank_rows``
    row-slots of ``bank_width`` columns and an occupancy counter;
  * a tile of shape ``(B, N)`` occupies ``ceil(N / bank_width)`` banks
    (its *shard group*), consuming ``B`` row-slots in each; shard banks are
    chosen least-occupied-first to balance load;
  * readiness mirrors the manager's gating: each shard bank raises a local
    ``loaded`` bit, the manager AND-combines them into tile-ready and
    OR-combines all tiles' bits into pool-busy (`any_pending`);
  * an oversized tile (``shards > banks``) needs the pool fully idle and is
    executed in ``ceil(shards / banks)`` waves with every bank enlisted —
    the §IV behaviour of a dataset larger than the total bank capacity; its
    partial final wave frees the banks it does not need one wave early.

The event-driven :class:`ContinuousScheduler` is the ONLY
scheduler (the legacy batch-synchronous wave loop was removed; its flushed
behaviour is pinned by recorded golden telemetry in
``tests/golden/continuous_telemetry.json``).  It runs the pool on an
explicit **event clock** — a virtual-time heap of tile-arrival, bank-drain
(early-release), and tile-retire events:

  * a tile is *admitted* (placed + executed) the moment enough banks have
    drained — at its arrival event if the pool has room, otherwise at the
    first early-release/retire event that frees its shard group;
  * queued tiles admit FIFO with best-effort skip-scan (a tile that does
    not fit never blocks a later one that does), and every retire frees
    banks for the queue immediately, with **no epoch boundary**;
  * an :class:`AdmissionPolicy` is evaluated at every arrival event
    and may *accept*, *defer* (re-schedule the arrival with a deadline), or
    *shed* (fail the tile deterministically with :class:`ShedError`) — the
    overload control that keeps the event heap and admission queue bounded
    when offered load exceeds pool capacity.

Event-model invariants (pinned by tests/test_continuous.py and
tests/test_overload.py)
-----------------------------------------------------------------------

1. **Virtual-time units.**  The event clock ``vt`` advances in *modeled
   hardware cycles* (the §V cycle domain): a tile's per-wave service
   duration is its summed exact cycle telemetry, falling back to the §V
   cost-model estimate for backends that do not simulate cycles.  No event
   ever fires at a ``vt`` lower than the current clock; the loop is
   deterministic and sleep-free.
2. **Bank-cycle conservation.**  All banks in a shard group step their
   column registers together (CR enables are OR-combined), so a tile's
   cycle count is charged to *every* bank of its group, once per wave —
   matching §V.C's result that multi-bank management changes area/power,
   never latency.  Pool-wide ``busy_cycles`` therefore depends only on the
   tile set, not on arrival order or admission times.
3. **Owner-scoped abort.**  :meth:`ContinuousScheduler.abort` evicts
   exactly the queued + in-flight tiles fed under one ``owner`` token
   (banks released with no telemetry credit, pending events cancelled in
   place); co-resident owners — other streaming sessions — are untouched.
4. **Exactly-once sinks.**  Every fed tile's ``sink`` is called exactly
   once: at its retire event, at its execution failure, or at its shed
   decision (with :class:`ShedError`); a shed or failed tile is consumed,
   never silently dropped or re-executed.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

from .batcher import Tile
from .faults import FaultError, RecoveryPolicy

__all__ = ["ACCEPT", "AdmissionPolicy", "BankPool", "ContinuousScheduler",
           "ContinuousStats", "DEFER", "LogicalBank", "SHED",
           "SchedulerStats", "ShedError", "WatermarkPolicy"]


@dataclass
class LogicalBank:
    """One bank: fixed row capacity plus serving telemetry."""

    index: int
    bank_rows: int
    free_rows: int = field(init=False)
    loaded: set = field(default_factory=set)   # tile ids resident here
    tiles_served: int = 0
    rows_served: int = 0
    busy_cycles: int = 0

    def __post_init__(self):
        self.free_rows = self.bank_rows

    def load(self, tile_id: int, rows: int) -> None:
        assert rows <= self.free_rows, "placement bug: bank over-committed"
        self.free_rows -= rows
        self.loaded.add(tile_id)

    def release(self, tile_id: int, rows: int) -> None:
        self.free_rows += rows
        self.loaded.discard(tile_id)


@dataclass
class _Placement:
    tile: Tile
    tile_id: int
    bank_ids: list[int]
    waves: int = 1
    # banks still needed in the final wave; the rest free one wave early
    tail_banks: list[int] = field(default_factory=list)
    early_released: bool = False

    def __post_init__(self):
        if not self.tail_banks:
            self.tail_banks = list(self.bank_ids)

    @property
    def early_banks(self) -> list[int]:
        tail = set(self.tail_banks)
        return [i for i in self.bank_ids if i not in tail]


class BankPool:
    def __init__(self, banks: int = 8, bank_width: int = 1024, bank_rows: int = 8):
        if banks < 1 or bank_width < 1 or bank_rows < 1:
            raise ValueError("banks, bank_width, bank_rows must be >= 1")
        self.bank_width = bank_width
        self.banks = [LogicalBank(i, bank_rows) for i in range(banks)]

    def shards_for(self, n_cols: int) -> int:
        return -(-n_cols // self.bank_width)

    def bank_labels(self) -> list[str]:
        """Human-readable per-bank track names (trace export).  Mesh pools
        override this to name the device each bank is pinned to."""
        return [f"bank {b.index}" for b in self.banks]

    def try_place(self, tile: Tile, tile_id: int,
                  exclude: frozenset = frozenset()) -> _Placement | None:
        """Reserve a shard group for the tile, least-occupied banks first.

        ``exclude`` removes banks from eligibility (health quarantine): the
        tile places — and, when wider than the survivors, waves — over the
        remaining capacity only.  Empty (the default) is the byte-identical
        pre-fault behaviour."""
        b_rows, n_cols = tile.shape
        shards = self.shards_for(n_cols)
        if b_rows > self.banks[0].bank_rows:
            return None                   # taller than any bank can ever hold
        avail = (self.banks if not exclude else
                 [b for b in self.banks if b.index not in exclude])
        if not avail:
            return None                   # every bank quarantined right now
        if shards > len(avail):
            # oversized: only placeable into idle survivors, as wave execution
            if all(b.free_rows == b.bank_rows for b in avail):
                waves = -(-shards // len(avail))
                for bank in avail:
                    bank.load(tile_id, b_rows)
                tail = shards % len(avail) or len(avail)
                return _Placement(tile, tile_id, [b.index for b in avail],
                                  waves=waves,
                                  tail_banks=[b.index for b in avail[:tail]])
            return None
        free = sorted((b for b in avail if b.free_rows >= b_rows),
                      key=lambda b: (b.bank_rows - b.free_rows, b.index))
        if len(free) < shards:
            return None
        chosen = free[:shards]
        for bank in chosen:
            bank.load(tile_id, b_rows)
        return _Placement(tile, tile_id, [b.index for b in chosen])

    def ready(self, placement: _Placement) -> bool:
        """Manager gate: AND of per-bank loaded bits for this tile."""
        return all(placement.tile_id in self.banks[i].loaded
                   for i in placement.bank_ids)

    def any_pending(self) -> bool:
        """OR-combined pool-busy predicate (the manager's global enable)."""
        return any(bank.loaded for bank in self.banks)

    def release_early(self, placement: _Placement, cycles: int | None) -> None:
        """Free the banks an oversized tile's partial final wave never uses.

        They were busy for ``waves - 1`` waves only; releasing them when the
        last wave starts lets queued tiles be admitted mid-wave."""
        if placement.early_released:
            return
        b_rows = placement.tile.shape[0]
        for i in placement.early_banks:
            bank = self.banks[i]
            bank.release(placement.tile_id, b_rows)
            bank.tiles_served += 1
            bank.rows_served += b_rows
            if cycles is not None:
                bank.busy_cycles += int(cycles) * (placement.waves - 1)
        placement.early_released = True

    def retire(self, placement: _Placement, cycles: int | None) -> None:
        b_rows = placement.tile.shape[0]
        banks_left = (placement.tail_banks if placement.early_released
                      else placement.bank_ids)
        for i in banks_left:
            bank = self.banks[i]
            bank.release(placement.tile_id, b_rows)
            bank.tiles_served += 1
            bank.rows_served += b_rows
            if cycles is not None:
                # synchronized column stepping: every shard bank is busy for
                # the full tile latency (x waves for oversized tiles)
                bank.busy_cycles += int(cycles) * placement.waves


@dataclass
class SchedulerStats:
    """Admission/placement counters shared by pool-level telemetry."""

    tiles: int = 0
    drains: int = 0                 # retire events (every retire is a drain)
    oversized_tiles: int = 0
    oversized_waves: int = 0
    max_banks_in_flight: int = 0
    mid_wave_admissions: int = 0    # tiles admitted onto early-freed banks


# --------------------------------------------------------------------------
# Overload control: admission policies
# --------------------------------------------------------------------------

ACCEPT, DEFER, SHED = "accept", "defer", "shed"


class ShedError(RuntimeError):
    """A tile refused by the admission policy under overload.

    Delivered deterministically — to the tile's sink (``strict=False``
    sessions surface it via ``take_failures``; the async front door maps it
    onto the caller's future) or raised out of ``pump`` for strict feeds.
    ``retry_after_vt`` is the policy's suggested back-off in virtual cycles.
    """

    def __init__(self, message: str, retry_after_vt: float = 0.0):
        super().__init__(message)
        self.retry_after_vt = float(retry_after_vt)


class AdmissionPolicy:
    """Decide the fate of each tile at its arrival event.

    :meth:`decide` is called once per processed arrival (first arrival and
    every deferred re-arrival) with the scheduler's load signals and must
    return ``(action, retry_after_vt)`` where action is :data:`ACCEPT`,
    :data:`DEFER` (re-schedule the arrival ``retry_after_vt`` virtual cycles
    later), or :data:`SHED` (fail the tile with :class:`ShedError`).

    Policies may keep state; ``crossings`` is read into telemetry as
    ``high_watermark_crossings`` (count of entries into the overloaded
    regime).  The default policy accepts everything.
    """

    crossings: int = 0

    def decide(self, *, depth: int, occupancy: float, vt: float,
               waited_vt: float, defers: int) -> tuple[str, float]:
        return (ACCEPT, 0.0)


@dataclass
class WatermarkPolicy(AdmissionPolicy):
    """Queue-depth / occupancy watermarks with hysteresis.

    The scheduler is *overloaded* once the admission queue reaches
    ``high_watermark`` tiles (or, when ``occupancy_high`` is set, the pool
    occupancy reaches it while a queue exists), and stays overloaded until
    the queue falls back to ``low_watermark`` (default: half the high mark).
    While overloaded:

      * ``shed=True`` — new arrivals are shed outright (:class:`ShedError`
        with ``retry_after_vt`` as the suggested back-off);
      * ``shed=False`` — new arrivals are deferred: their arrival event is
        re-scheduled ``retry_after_vt`` virtual cycles later, up to
        ``deadline_vt`` of total waiting, after which the tile is accepted
        unconditionally — **no tile is ever lost when shedding is off**.

    ``crossings`` counts transitions into the overloaded regime and is
    monotone in offered load for a fixed trace prefix (pinned by
    tests/test_overload.py).
    """

    high_watermark: int = 64
    low_watermark: int | None = None
    occupancy_high: float | None = None
    shed: bool = False
    retry_after_vt: float = 4096.0
    deadline_vt: float = 1 << 20
    crossings: int = field(default=0, init=False)
    _over: bool = field(default=False, init=False, repr=False)

    def __post_init__(self):
        if self.high_watermark < 1:
            raise ValueError("high_watermark must be >= 1")
        low = (self.high_watermark // 2 if self.low_watermark is None
               else self.low_watermark)
        if not 0 <= low < self.high_watermark:
            raise ValueError(
                f"low_watermark={low} must be in [0, high_watermark)")
        if self.occupancy_high is not None and \
                not 0.0 < self.occupancy_high <= 1.0:
            raise ValueError(
                f"occupancy_high={self.occupancy_high} must be in (0, 1]")
        # instance attributes throughout (init=False defaults stay
        # class-level): the engine snapshots/restores policy state via vars()
        self._low = low
        self.crossings = 0
        self._over = False

    def decide(self, *, depth: int, occupancy: float, vt: float,
               waited_vt: float, defers: int) -> tuple[str, float]:
        low = self._low
        over_now = depth >= self.high_watermark or (
            self.occupancy_high is not None
            and occupancy >= self.occupancy_high and depth > 0)
        if self._over and depth <= low and not over_now:
            self._over = False
        if not self._over and over_now:
            self._over = True
            self.crossings += 1
        if not self._over:
            return (ACCEPT, 0.0)
        if self.shed:
            return (SHED, self.retry_after_vt)
        if waited_vt >= self.deadline_vt:
            return (ACCEPT, 0.0)        # deadline reached: never lose it
        return (DEFER, self.retry_after_vt)


# --------------------------------------------------------------------------
# Continuous (event-driven) operation
# --------------------------------------------------------------------------

@dataclass
class ContinuousStats(SchedulerStats):
    """Placement counters plus the event-clock and overload quantities.

    Virtual-time fields are in modeled hardware cycles; ``drains`` counts
    retire events (every retire is a drain — there are no batch flushes)."""

    arrivals: int = 0
    admissions: int = 0             # == tiles; kept for symmetry with queue
    events: int = 0                 # heap events processed
    exec_failures: int = 0          # failed tile executions (either mode)
    fault_failures: int = 0         # FaultError executions (retried or not)
    retries: int = 0                # fault re-arrivals scheduled (backoff)
    fault_exhausted: int = 0        # tiles that ran out of fault retries
    queued_peak: int = 0
    deferred: int = 0               # admission-policy deferrals (re-arrivals)
    shed: int = 0                   # admission-policy rejections
    queue_wait_vt: float = 0.0      # sum over admitted tiles of admit - arrive
    busy_bank_vt: float = 0.0       # integral of bank-busy virtual time
    makespan_vt: float = 0.0        # vt of the latest retire


_ARRIVE, _EARLY, _RETIRE = 0, 1, 2


@dataclass(eq=False)                    # identity semantics: jobs are removed
class _Job:                             # from lists and compared by object
    """One tile travelling through the event loop."""

    tile: Tile
    execute: Callable[[Tile], object]
    sink: Callable | None           # sink(tile, result, exc) at retire/failure
    strict: bool                    # True: execute errors propagate (+ abort)
    owner: object                   # abort()/session scope token
    arrive_vt: float
    defers: int = 0                 # admission-policy deferrals so far
    attempts: int = 0               # failed fault-retried executions so far
    cancelled: bool = False


@dataclass(eq=False)                    # identity semantics (see _Job)
class _Flight:
    """An admitted tile: its placement plus scheduled event bookkeeping."""

    job: _Job
    placement: _Placement
    result: object
    total_cycles: int | None        # exact cycles for pool telemetry credit
    duration_vt: float              # per-wave virtual service time
    admit_vt: float = 0.0           # event-clock instant the tile was placed
    cancelled: bool = False


class ContinuousScheduler:
    """Event-driven bank scheduler: admission the moment banks drain.

    Tiles are fed at any time (:meth:`feed`), optionally with explicit
    virtual arrival times; :meth:`pump` advances the event clock until every
    scheduled event has fired.  Execution happens at admission (software
    results are available immediately); bank occupancy, queue waits, and
    latency follow the virtual clock in modeled hardware cycles, so the
    whole loop is deterministic and sleep-free (see the module docstring's
    invariants).

    ``sink(tile, result, exc)`` is called exactly once per tile — at its
    retire event, at its execution failure (``strict=False``), or at its
    shed decision (``exc`` a :class:`ShedError`).  ``owner`` scopes
    :meth:`abort`: a failed engine batch can evict exactly its own tiles —
    queued and in-flight — without touching co-resident streaming sessions.

    ``policy`` (an :class:`AdmissionPolicy`) is evaluated at every arrival
    event and may defer or shed tiles under overload; ``None`` accepts
    everything — the heap then grows with whatever the callers feed.

    :meth:`run` keeps the flushed call shape (feed everything now, pump to
    quiescence, return ``(tile, result)`` pairs) for batch workloads; its
    behaviour is pinned by recorded golden telemetry in
    ``tests/golden/continuous_telemetry.json``.
    """

    def __init__(self, pool: BankPool, *,
                 policy: AdmissionPolicy | None = None,
                 on_event: Callable | None = None,
                 health=None, recovery: RecoveryPolicy | None = None,
                 prefetch: Callable | None = None):
        self.pool = pool
        self.policy = policy
        # prefetch(tile) — double-buffer hook, called with the next queued
        # tile right before the current admission executes, so a backend
        # can overlap the next transfer with the current compute.  Must be
        # side-effect-free on scheduler state (no stats are recorded here —
        # mesh and local pools keep identical scheduler telemetry).
        self.prefetch = prefetch
        # on_event(kind, tile, vt, **attrs) — the flight-recorder hook.
        # kinds: arrive / defer / shed / admit / early / retire / exec_fail
        # plus the fault-recovery instants retry / quarantine / probe.
        # None (the default) keeps the event loop observation-free.
        self.on_event = on_event
        # bank-health tracker (repro_torch.sortserve.faults.BankHealth) and the
        # virtual-time retry schedule for FaultError executions.  An
        # inactive (or absent) tracker keeps every fault hook on the
        # zero-cost path — faults-off behaviour is byte-identical.
        self.health = health
        self.recovery = recovery if recovery is not None else RecoveryPolicy()
        self.stats = ContinuousStats()
        self.vt = 0.0                       # the event clock (virtual cycles)
        self._heap: list = []               # (t, seq, kind, payload)
        self._seq = itertools.count()
        self._ids = itertools.count()
        self._queue: list[_Job] = []        # FIFO, skip-scan admitted
        self._inflight: list[_Flight] = []
        # virtual-time stamps of recent retires: the live drain-rate signal
        # behind retry-after hints (bounded; snapshotted by the engine for
        # all-or-nothing submit rollback)
        self._drain_vts: deque = deque(maxlen=256)

    # ------------------------------------------------------------- ingress
    def feed(self, tiles, execute: Callable[[Tile], object], sink=None, *,
             at: float | None = None, strict: bool = True,
             owner: object = None) -> None:
        """Schedule arrival events for ``tiles`` (no admission happens yet —
        call :meth:`pump`).  ``at`` is a virtual arrival time; ``None``
        means "now" (the current event clock)."""
        bank_rows = self.pool.banks[0].bank_rows
        for tile in tiles:
            if tile.shape[0] > bank_rows:
                raise ValueError(
                    f"tile {tile.shape} cannot be placed even on an "
                    f"idle pool: need bank_rows >= {tile.shape[0]} "
                    f"(have {bank_rows})")
            t = self.vt if at is None else float(at)
            job = _Job(tile, execute, sink, strict, owner, t)
            heapq.heappush(self._heap, (t, next(self._seq), _ARRIVE, job))

    # ---------------------------------------------------------- event loop
    def pump(self) -> int:
        """Fire events in virtual-time order until the heap is empty.

        Returns the number of events processed.  Raises the execute
        exception of a ``strict`` tile (after releasing its banks) and the
        :class:`ShedError` of a strict shed tile; a non-strict tile's
        failure or shed goes to its sink instead."""
        fired = 0
        while self._heap or self._queue:
            if not self._heap:
                # quiescent heap with a residual queue: the pool is idle (a
                # busy pool implies a pending retire event), so either the
                # queue admits now — scheduling fresh events — or its head
                # can never fit and _drain_queue raises
                self._drain_queue(mid_wave=False)
                continue
            t, _, kind, payload = heapq.heappop(self._heap)
            if payload.cancelled:
                continue
            self.vt = max(self.vt, t)
            fired += 1
            self.stats.events += 1
            if kind == _ARRIVE:
                self._on_arrive(payload)
            elif kind == _EARLY:
                pl = payload.placement
                self.pool.release_early(pl, payload.total_cycles)
                self.stats.busy_bank_vt += (payload.duration_vt
                                            * (pl.waves - 1)
                                            * len(pl.early_banks))
                if self.on_event is not None:
                    self.on_event("early", payload.job.tile, self.vt,
                                  bank_ids=list(pl.early_banks))
                self._drain_queue(mid_wave=True)
            else:                                          # _RETIRE
                fl = payload
                pl = fl.placement
                banks_left = (pl.tail_banks if pl.early_released
                              else pl.bank_ids)
                self.pool.retire(pl, fl.total_cycles)
                self.stats.busy_bank_vt += (fl.duration_vt * pl.waves
                                            * len(banks_left))
                self.stats.drains += 1
                self.stats.makespan_vt = max(self.stats.makespan_vt, self.vt)
                self._drain_vts.append(self.vt)
                self._inflight.remove(fl)
                if self.on_event is not None:
                    self.on_event(
                        "retire", fl.job.tile, self.vt,
                        admit_vt=fl.admit_vt, duration_vt=fl.duration_vt,
                        waves=pl.waves, bank_ids=list(pl.bank_ids),
                        early_banks=(list(pl.early_banks)
                                     if pl.early_released else []),
                        total_cycles=fl.total_cycles)
                if fl.job.sink is not None:
                    fl.job.sink(fl.job.tile, fl.result, None)
                self._drain_queue(mid_wave=False)
        return fired

    def _on_arrive(self, job: _Job) -> None:
        """One arrival event: admission-policy gate, then admit or queue."""
        if job.defers == 0 and job.attempts == 0:
            self.stats.arrivals += 1        # deferred/retried count once
            job.arrive_vt = max(job.arrive_vt, self.vt)
            if self.on_event is not None:
                self.on_event("arrive", job.tile, self.vt)
        action, retry = ACCEPT, 0.0
        if self.policy is not None:
            busy = sum(1 for b in self.pool.banks if b.loaded)
            # watermarks recompute against *surviving* capacity: quarantined
            # banks leave the occupancy denominator, so the same queue
            # pressure trips backpressure earlier on a degraded pool
            denom = len(self.pool.banks)
            if self.health is not None and self.health.active:
                denom = max(1, denom - len(self.health.ineligible(self.vt)))
            action, retry = self.policy.decide(
                depth=len(self._queue),
                occupancy=busy / denom,
                vt=self.vt, waited_vt=self.vt - job.arrive_vt,
                defers=job.defers)
        if action == SHED:
            self.stats.shed += 1
            if self.on_event is not None:
                self.on_event("shed", job.tile, self.vt,
                              depth=len(self._queue), retry_after_vt=retry)
            exc = ShedError(
                f"admission shed at queue depth {len(self._queue)} "
                f"(vt={self.vt:.0f})", retry_after_vt=retry)
            if job.sink is not None:
                job.sink(job.tile, None, exc)
            if job.strict:
                raise exc
            return
        if action == DEFER:
            self.stats.deferred += 1
            job.defers += 1
            if self.on_event is not None:
                self.on_event("defer", job.tile, self.vt,
                              retry_after_vt=retry, defers=job.defers)
            heapq.heappush(self._heap, (self.vt + max(retry, 1.0),
                                        next(self._seq), _ARRIVE, job))
            return
        if self._queue or not self._try_admit(job):
            self._queue.append(job)
            self.stats.queued_peak = max(self.stats.queued_peak,
                                         len(self._queue))

    # ----------------------------------------------------------- admission
    def _release_unserved(self, pl: _Placement) -> None:
        """Free a failed admission's banks with no telemetry credit."""
        b_rows = pl.tile.shape[0]
        for i in pl.bank_ids:
            bank = self.pool.banks[i]
            if pl.tile_id in bank.loaded:
                bank.release(pl.tile_id, b_rows)

    def _on_fault(self, job: _Job, pl: _Placement, exc: FaultError) -> bool:
        """Recovery path for an injected-fault execution: charge health,
        schedule a bounded virtual-time backoff re-arrival, or — retries
        exhausted — fail the tile through the normal exec_fail contract.
        The job is consumed either way (never left queued)."""
        self.stats.fault_failures += 1
        if self.health is not None and self.health.active:
            blamed = list(exc.bank_ids) or list(pl.bank_ids)
            for b in self.health.record_error(blamed, self.vt):
                if self.on_event is not None:
                    self.on_event("quarantine", job.tile, self.vt, bank=b,
                                  error=type(exc).__name__,
                                  release_vt=self.health.records[b].release_vt)
        job.attempts += 1
        job.tile.obs["fault_attempts"] = job.attempts
        if job.attempts <= self.recovery.max_retries:
            delay = self.recovery.delay_vt(job.attempts)
            self.stats.retries += 1
            if self.on_event is not None:
                self.on_event("retry", job.tile, self.vt,
                              attempt=job.attempts, delay_vt=delay,
                              error=type(exc).__name__)
            heapq.heappush(self._heap, (self.vt + delay, next(self._seq),
                                        _ARRIVE, job))
            return True                         # consumed; re-arrives later
        self.stats.fault_exhausted += 1
        self.stats.exec_failures += 1
        if self.on_event is not None:
            self.on_event("exec_fail", job.tile, self.vt,
                          error=type(exc).__name__)
        if job.sink is not None:
            job.sink(job.tile, None, exc)
        if job.strict:
            raise exc
        return True

    def _try_admit(self, job: _Job) -> bool:
        exclude = (self.health.ineligible(self.vt)
                   if self.health is not None and self.health.active
                   else frozenset())
        pl = self.pool.try_place(job.tile, next(self._ids), exclude=exclude)
        if pl is None:
            return False
        self.stats.tiles += 1
        self.stats.admissions += 1
        self.stats.queue_wait_vt += self.vt - job.arrive_vt
        if pl.waves > 1:
            self.stats.oversized_tiles += 1
            self.stats.oversized_waves += pl.waves
        in_flight = sum(1 for b in self.pool.banks if b.loaded)
        self.stats.max_banks_in_flight = max(
            self.stats.max_banks_in_flight, in_flight)
        if self.on_event is not None:
            self.on_event("admit", job.tile, self.vt,
                          bank_ids=list(pl.bank_ids), waves=pl.waves,
                          queue_wait_vt=self.vt - job.arrive_vt)
        # the executing layer (fault injection, bank-targeted attribution)
        # needs to know which shard group this execution runs on
        job.tile.obs["bank_ids"] = list(pl.bank_ids)
        if self.prefetch is not None:
            # double buffering: stage the next queued tile's transfer so it
            # lands while this tile's execution traverses planes (the job
            # being admitted may still sit in _queue during a drain scan)
            nxt = next((j.tile for j in self._queue
                        if j is not job and not j.cancelled), None)
            if nxt is not None:
                self.prefetch(nxt)
        try:
            result = job.execute(job.tile)
        except FaultError as exc:
            self._release_unserved(pl)
            return self._on_fault(job, pl, exc)
        except BaseException as exc:
            self._release_unserved(pl)
            self.stats.exec_failures += 1
            if self.on_event is not None:
                self.on_event("exec_fail", job.tile, self.vt,
                              error=type(exc).__name__)
            # the sink hears about the failure in BOTH modes, so a session's
            # bookkeeping stays coherent (requests leave the outstanding set
            # and can be re-fed) even when the exception propagates
            if job.sink is not None:
                job.sink(job.tile, None, exc)
            if job.strict:
                raise
            return True                         # consumed, not re-queued
        if self.health is not None and self.health.active:
            probing, reinstated = self.health.record_ok(pl.bank_ids, self.vt)
            if self.on_event is not None:
                for b in probing:
                    self.on_event("probe", job.tile, self.vt, bank=b,
                                  reinstated=b in reinstated)
        cycles = getattr(result, "cycles", None)
        total = int(cycles.sum()) if cycles is not None else None
        dur = float(total) if total is not None else float(
            getattr(result, "estimated_cycles", None) or 0.0)
        # a slow bank in the shard group stretches virtual service time;
        # the cycle *credit* (total) is untouched, so bank-cycle
        # conservation is arrival- and fault-order independent
        meta = getattr(result, "meta", None)
        if isinstance(meta, dict):
            slow = meta.get("fault_slow_mult")
            if slow is not None and float(slow) != 1.0:
                dur *= float(slow)
        fl = _Flight(job, pl, result, total, dur, admit_vt=self.vt)
        self._inflight.append(fl)
        if pl.waves > 1 and pl.early_banks:
            heapq.heappush(self._heap, (self.vt + dur * (pl.waves - 1),
                                        next(self._seq), _EARLY, fl))
        heapq.heappush(self._heap, (self.vt + dur * pl.waves,
                                    next(self._seq), _RETIRE, fl))
        return True

    def _drain_queue(self, mid_wave: bool) -> None:
        """Admit queued tiles FIFO with best-effort skip-scan.

        An oversized head (wider than the whole pool) holds the door: it
        needs the pool fully idle, and admitting later tiles around it
        forever would starve it — so nothing behind it is admitted until it
        places, the continuous analogue of a forced drain-until-fit.  A
        merely-large (but poolable) head is retried first at every drain
        event, so it admits as soon as its shard group frees; skip-scan
        behind it trades strict FIFO for bank utilization, the usual
        continuous-batching compromise."""
        while True:
            progress = True
            while progress:
                progress = False
                i = 0
                while i < len(self._queue):
                    job = self._queue[i]
                    if job.cancelled:
                        self._queue.pop(i)
                        continue
                    try:
                        admitted = self._try_admit(job)
                    except BaseException:
                        # a strict execute failure consumed the job (its sink
                        # was told); leaving it queued would re-execute it on
                        # the next pump
                        self._queue.pop(i)
                        raise
                    if admitted:
                        self._queue.pop(i)
                        if mid_wave:
                            self.stats.mid_wave_admissions += 1
                        progress = True
                        continue
                    if self.pool.shards_for(job.tile.shape[1]) > \
                            len(self.pool.banks):
                        break                   # hold the door (see above)
                    i += 1
            # quarantine can stall the queue on an *idle* pool (survivors
            # too few for the head).  With no pending event to call back,
            # advance the clock to the earliest quarantine release — the
            # bank re-enters on probation — and rescan; each pass either
            # admits or strictly advances vt to a later release, so this
            # terminates
            if (self._queue and not self._heap
                    and not self.pool.any_pending()
                    and self.health is not None and self.health.active):
                nxt = self.health.next_release_vt()
                if nxt is not None:
                    self.vt = max(self.vt, nxt)
                    continue
            break
        # progress invariant: feed() rejects tiles taller than a bank, and
        # any feed-accepted tile places on a fully idle pool (oversized
        # widths via the wave path) — so a stalled queue implies busy banks
        # (a pending retire event that will call back here), a pending heap
        # event, or a quarantine release that the next heap-empty drain
        # will fast-forward to
        assert (not self._queue or self.pool.any_pending() or self._heap
                or (self.health is not None
                    and self.health.next_release_vt() is not None)), \
            "queue stalled on an idle pool despite feed-time validation"

    # ------------------------------------------------------------- control
    def abort(self, owner: object) -> None:
        """Evict every queued and in-flight tile fed under ``owner``.

        Banks are released with no telemetry credit; pending events for the
        evicted tiles — arrivals not yet processed included — are cancelled
        in place (lazy heap deletion).  Tiles of other owners are untouched
        — a failed engine batch must not poison co-resident streaming
        sessions."""
        for _, _, kind, payload in self._heap:
            if kind == _ARRIVE and payload.owner is owner:
                payload.cancelled = True
        for job in self._queue:
            if job.owner is owner:
                job.cancelled = True
        self._queue = [j for j in self._queue if not j.cancelled]
        for fl in list(self._inflight):
            if fl.job.owner is not owner:
                continue
            fl.cancelled = True
            b_rows = fl.job.tile.shape[0]
            for i in fl.placement.bank_ids:
                bank = self.pool.banks[i]
                if fl.placement.tile_id in bank.loaded:
                    bank.release(fl.placement.tile_id, b_rows)
            self._inflight.remove(fl)

    def idle(self) -> bool:
        """True when no event, queued tile, or in-flight tile remains."""
        return not (self._heap or self._queue or self._inflight)

    def queue_depth(self) -> int:
        """Current admission-queue depth (the live windowed-metrics gauge)."""
        return len(self._queue)

    def drain_rate_vt(self) -> float:
        """Recent retires per virtual cycle over the bounded drain window
        (0.0 until two retires at distinct instants exist) — the signal
        retry-after hints and the fleet router derive service rate from."""
        d = self._drain_vts
        if len(d) < 2 or d[-1] <= d[0]:
            return 0.0
        return (len(d) - 1) / (d[-1] - d[0])

    # ------------------------------------------------- flushed-batch frontend
    def run(self, tiles: list[Tile],
            execute: Callable[[Tile], object]) -> list[tuple[Tile, object]]:
        """Flushed-workload frontend: feed everything now, pump to
        quiescence, return ``(tile, result)`` in retire order — the batch
        call shape, through the identical event-clock admission path the
        streaming API uses."""
        results: list[tuple[Tile, object]] = []
        token = object()
        try:
            self.feed(tiles, execute,
                      sink=lambda tile, result, exc:
                          results.append((tile, result)),
                      strict=True, owner=token)
            self.pump()
        except BaseException:
            self.abort(token)
            raise
        if not self._inflight:
            assert not self.pool.any_pending(), \
                "banks left loaded after quiescence"
        return results

    def telemetry(self) -> dict:
        s = self.stats
        banks = len(self.pool.banks)
        occupancy = (s.busy_bank_vt / (banks * s.makespan_vt)
                     if s.makespan_vt > 0 else 0.0)
        return {
            "tiles": s.tiles,
            "drains": s.drains,
            "oversized_tiles": s.oversized_tiles,
            "oversized_waves": s.oversized_waves,
            "max_banks_in_flight": s.max_banks_in_flight,
            "mid_wave_admissions": s.mid_wave_admissions,
            "banks": [
                {"index": b.index, "tiles_served": b.tiles_served,
                 "rows_served": b.rows_served, "busy_cycles": b.busy_cycles}
                for b in self.pool.banks
            ],
            "continuous": {
                "arrivals": s.arrivals,
                "admissions": s.admissions,
                "events": s.events,
                "exec_failures": s.exec_failures,
                "queue_depth": len(self._queue),
                "queued_peak": s.queued_peak,
                "deferred": s.deferred,
                "shed": s.shed,
                "high_watermark_crossings": getattr(self.policy,
                                                    "crossings", 0),
                "queue_wait_vt": s.queue_wait_vt,
                "busy_bank_vt": s.busy_bank_vt,
                "makespan_vt": s.makespan_vt,
                "occupancy": occupancy,
                "drain_rate_vt": self.drain_rate_vt(),
            },
        }
