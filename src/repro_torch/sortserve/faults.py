"""Bank fault injection, health quarantine, and verified-retry recovery.

The paper's sorter runs on a 1T1R memristive array, and real memristive
devices fail: stuck-at columns, transient read upsets, drifting cells, and
outright dead banks are the dominant reliability concerns of the related
memristive-sorting literature.  The serving stack built in PRs 1-7 assumed
every bank always answers correctly; this module makes that assumption
explicit — and removable:

  * :class:`FaultPlan` — a deterministic, seeded description of what goes
    wrong: per-bank stuck-at-0/1 bit lanes, a transient execute-error rate,
    permanently dead banks, and slow banks (virtual-time latency
    multipliers).  Injection happens **in virtual time** on the engine's
    execute path via ``EngineConfig(faults=...)`` and is a strict no-op
    when absent or disabled — the faults-off golden telemetry stays
    byte-identical (pinned by ``tests/test_faults.py``).
  * :class:`FaultInjector` — applies a plan to tile results with its own
    ``numpy`` Generator, so a given (seed, workload) chaos run is exactly
    reproducible.
  * :class:`FaultError` and friends — the typed failure taxonomy the
    scheduler's retry path recognizes; anything else keeps the pre-existing
    ``exec_fail`` semantics untouched.
  * :func:`verify_tile_result` — the cheap result-verification guard: row
    ordering, index-gather agreement, and a sum/xor permutation digest
    against the tile's own input.  No oracle re-sort; corruption a stuck
    lane introduces is always caught (a stuck-at flip strictly changes the
    row sum).
  * :class:`BankHealth` — per-bank error scoring with a quarantine /
    probation state machine: a bank whose score crosses the threshold
    leaves ``BankPool.try_place`` eligibility until its release instant,
    then serves ``probation_tiles`` clean probe tiles before full
    reinstatement; a failed probe re-quarantines with doubled duration, so
    a permanently dead bank decays out of the rotation while a transient
    victim returns after a few clean probes.
  * :class:`RecoveryPolicy` — bounded deterministic virtual-time backoff
    for retried tiles plus the escalation point at which the engine stops
    re-trying the faulty in-memory backend and falls back to a software
    backend (``jaxsort``/``numpy``) for the tile.

Exactly-once delivery, owner-scoped abort, and the engine's all-or-nothing
submit rollback all hold under injection — the recovery pipeline lives
inside the scheduler's admission path (a faulted tile is *consumed* and
re-arrives later; its sink still fires exactly once), and
:meth:`BankHealth.snapshot` / :meth:`FaultInjector.snapshot` participate in
``_snapshot_state`` like every other counter.  See ``docs/robustness.md``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "BANK_HEALTHY",
    "BANK_PROBATION",
    "BANK_QUARANTINED",
    "BankDeadError",
    "BankHealth",
    "CorruptResultError",
    "FaultError",
    "FaultInjector",
    "FaultPlan",
    "RecoveryPolicy",
    "TransientFaultError",
    "verify_tile_result",
]


# --------------------------------------------------------------------------
# Typed failure taxonomy
# --------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base of the injected-fault taxonomy.

    Only :class:`FaultError` subclasses take the scheduler's retry path;
    any other execute exception keeps the original ``exec_fail`` semantics
    (sink + propagate when strict).  ``bank_ids`` names the banks the
    error is blamed on — health scoring charges exactly those."""

    def __init__(self, message: str, bank_ids: tuple = ()):
        super().__init__(message)
        self.bank_ids = tuple(bank_ids)


class TransientFaultError(FaultError):
    """A transient read upset: the execution failed once; a retry on the
    same banks may well succeed."""


class BankDeadError(FaultError):
    """A permanently dead bank in the tile's shard group: every execution
    touching it fails until quarantine removes it from placement."""


class CorruptResultError(FaultError):
    """The result-verification guard rejected a tile's output (stuck-lane
    corruption): wrong ordering, index disagreement, or digest mismatch."""


# --------------------------------------------------------------------------
# Fault plan + recovery policy
# --------------------------------------------------------------------------

# in-memory backends faults apply to; software fallbacks are immune, which
# is what makes the degradation ladder terminate
DEFAULT_FAULT_TARGETS = frozenset({"colskip", "colskip_mesh", "radix_topk"})


@dataclass(frozen=True)
class RecoveryPolicy:
    """Deterministic virtual-time retry/escalation schedule.

    A faulted tile re-arrives ``min(backoff_base_vt * 2**(attempt-1),
    backoff_cap_vt)`` virtual cycles later, at most ``max_retries`` times;
    once ``escalate_after`` attempts failed the engine routes the tile to
    the first enabled non-target backend (``jaxsort``/``numpy``) instead of
    the faulty in-memory engine — the graceful-degradation rung that makes
    every chaos run converge."""

    max_retries: int = 4
    backoff_base_vt: float = 64.0
    backoff_cap_vt: float = 4096.0
    escalate_after: int = 2

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_vt <= 0 or self.backoff_cap_vt <= 0:
            raise ValueError("backoff bounds must be positive")
        if self.escalate_after < 1:
            raise ValueError("escalate_after must be >= 1")

    def delay_vt(self, attempt: int) -> float:
        """Backoff before re-arrival number ``attempt`` (1-based)."""
        return min(self.backoff_base_vt * 2.0 ** (max(attempt, 1) - 1),
                   self.backoff_cap_vt)


@dataclass(frozen=True)
class FaultPlan:
    """Seeded description of everything that goes wrong.

    * ``transient_rate`` — per-execution probability (on a targeted
      backend) of a :class:`TransientFaultError`;
    * ``dead_banks`` — bank indices whose every execution raises
      :class:`BankDeadError` (permanent death);
    * ``stuck_lanes`` — ``(bank, bit, value)`` triples: output columns the
      bank produced have ``bit`` forced to ``value`` (0 or 1), the classic
      stuck-at column defect — caught by :func:`verify_tile_result`;
    * ``slow_banks`` — ``bank -> multiplier`` mapping: a shard group
      containing the bank serves at ``multiplier`` x its virtual-time
      latency (cycle *credit* is unchanged, so bank-cycle conservation
      holds);
    * ``targets`` — backend names faults apply to (in-memory engines by
      default; software fallbacks are immune);
    * ``enabled=False`` — construct-but-disable: the whole layer becomes a
      strict no-op (the faults-off golden guarantee).
    """

    seed: int = 0
    transient_rate: float = 0.0
    dead_banks: tuple = ()
    stuck_lanes: tuple = ()             # ((bank, bit, value), ...)
    slow_banks: tuple = ()              # ((bank, multiplier), ...)
    targets: frozenset = DEFAULT_FAULT_TARGETS
    enabled: bool = True
    recovery: RecoveryPolicy = field(default_factory=RecoveryPolicy)

    def __post_init__(self):
        if not 0.0 <= self.transient_rate <= 1.0:
            raise ValueError("transient_rate must be in [0, 1]")
        for bank, bit, value in self.stuck_lanes:
            if value not in (0, 1):
                raise ValueError(f"stuck lane value must be 0 or 1, "
                                 f"got {value!r} for bank {bank}")
            if not 0 <= bit < 32:
                raise ValueError(f"stuck lane bit {bit} out of uint32 range")
        for bank, mult in self.slow_banks:
            if mult < 1.0:
                raise ValueError(f"slow-bank multiplier {mult} must be >= 1")

    @property
    def any_faults(self) -> bool:
        return bool(self.transient_rate > 0 or self.dead_banks
                    or self.stuck_lanes or self.slow_banks)

    def validate_banks(self, n_banks: int) -> None:
        """Reject bank indices outside the pool (engine construction)."""
        named = set(self.dead_banks)
        named |= {b for b, _, _ in self.stuck_lanes}
        named |= {b for b, _ in self.slow_banks}
        bad = sorted(b for b in named if not 0 <= b < n_banks)
        if bad:
            raise ValueError(
                f"FaultPlan names banks {bad} outside the pool "
                f"[0, {n_banks})")


# --------------------------------------------------------------------------
# Result-verification guard
# --------------------------------------------------------------------------

def verify_tile_result(tile, result) -> None:
    """Cheap corruption guard over a tile's own input — no oracle re-sort.

    Checks, vectorized over the whole tile:

      * **ordering** — every output row is non-decreasing (``topk``:
        non-increasing);
      * **gather agreement** — when indices exist, ``values`` equals the
        tile data gathered at ``indices`` (also bounds-checks indices);
      * **permutation digest** — for full-length outputs, per-row uint64
        sum and xor-reduce match the input row's (a stuck-at flip strictly
        changes the sum, so stuck corruption cannot slip through).

    Raises :class:`CorruptResultError` on the first violated invariant.
    """
    values = np.asarray(result.values)
    data = tile.data
    n = data.shape[1]
    if values.ndim != 2 or values.shape[0] != data.shape[0]:
        raise CorruptResultError(
            f"result shape {values.shape} mismatches tile {data.shape}")
    if values.shape[1] > 1:
        steps = values[:, 1:].astype(np.int64) - values[:, :-1].astype(np.int64)
        ordered = np.all(steps <= 0) if tile.op == "topk" else \
            np.all(steps >= 0)
        if not ordered:
            raise CorruptResultError(
                f"{tile.op} output rows are not ordered")
    idx = result.indices
    if idx is not None:
        idx = np.asarray(idx)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise CorruptResultError(
                f"indices outside [0, {n}) in {tile.op} output")
        rows = np.arange(data.shape[0])[:, None]
        if not np.array_equal(values, data[rows, idx]):
            raise CorruptResultError(
                f"{tile.op} values disagree with data gathered at indices")
    if values.shape[1] == n:            # full sort: multiset must survive
        v64 = values.astype(np.uint64)
        d64 = data.astype(np.uint64)
        if not (np.array_equal(v64.sum(axis=1), d64.sum(axis=1))
                and np.array_equal(np.bitwise_xor.reduce(v64, axis=1),
                                   np.bitwise_xor.reduce(d64, axis=1))):
            raise CorruptResultError(
                f"{tile.op} output is not a permutation of the input "
                "(sum/xor digest mismatch)")


# --------------------------------------------------------------------------
# Injector
# --------------------------------------------------------------------------

class FaultInjector:
    """Applies a :class:`FaultPlan` to executed tile results.

    Deterministic: one private ``numpy`` Generator seeded from the plan;
    under the engine's virtual clock the execution order is reproducible,
    so a (seed, workload) pair replays the identical fault sequence.
    ``snapshot``/``restore`` cover the Generator state and the injection
    counters, so a rolled-back submit replays the same draws."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.rng = np.random.default_rng(plan.seed)
        self.injected = {"transient": 0, "stuck": 0, "dead": 0, "slow": 0}
        self._dead = frozenset(plan.dead_banks)
        self._slow = dict(plan.slow_banks)

    @property
    def active(self) -> bool:
        return self.plan.enabled and self.plan.any_faults

    def inject(self, tile, result, bank_ids, bank_width: int) -> tuple:
        """Mutate/raise according to the plan for one executed tile.

        ``bank_ids`` is the tile's shard group in shard order (bank i of
        the list produced output columns ``[i*bank_width, (i+1)*bank_width)``
        clipped to the output width).  Raises :class:`BankDeadError` /
        :class:`TransientFaultError`; stuck lanes corrupt ``result.values``
        in place (the guard catches them) and slow banks annotate
        ``result.meta["fault_slow_mult"]`` for the scheduler's virtual
        service time.  Returns the banks whose stuck lanes corrupted the
        output (the guard's blame set)."""
        bank_ids = tuple(bank_ids)
        dead = sorted(self._dead.intersection(bank_ids))
        if dead:
            self.injected["dead"] += 1
            raise BankDeadError(
                f"bank {dead[0]} is dead (shard group {list(bank_ids)})",
                bank_ids=tuple(dead))
        if self.plan.transient_rate > 0 and \
                self.rng.random() < self.plan.transient_rate:
            self.injected["transient"] += 1
            raise TransientFaultError(
                f"transient read fault (shard group {list(bank_ids)})",
                bank_ids=bank_ids)
        corrupted = []
        values = np.asarray(result.values)
        if not values.flags.writeable:      # read-only views (e.g. from a tensor)
            values = values.copy()
        out = values.shape[1] if values.ndim == 2 else 0
        for bank, bit, value in self.plan.stuck_lanes:
            if bank not in bank_ids:
                continue
            shard = bank_ids.index(bank)
            lo = min(shard * bank_width, out)
            hi = min(lo + bank_width, out)
            if hi <= lo:
                continue                # bank's shard past the output width
            mask = np.uint32(1 << bit)
            region = values[:, lo:hi]
            forced = (region | mask) if value else (region & ~mask)
            if not np.array_equal(forced, region):
                values[:, lo:hi] = forced
                result.values = values
                corrupted.append(bank)
        if corrupted:
            self.injected["stuck"] += 1
        slow = [self._slow[b] for b in bank_ids if b in self._slow]
        if slow and isinstance(getattr(result, "meta", None), dict):
            result.meta["fault_slow_mult"] = float(max(slow))
            self.injected["slow"] += 1
        return tuple(corrupted)

    def snapshot(self) -> dict:
        return {"rng": copy.deepcopy(self.rng.bit_generator.state),
                "injected": dict(self.injected)}

    def restore(self, snap: dict) -> None:
        self.rng.bit_generator.state = copy.deepcopy(snap["rng"])
        self.injected = dict(snap["injected"])


# --------------------------------------------------------------------------
# Bank health: quarantine / probation state machine
# --------------------------------------------------------------------------

BANK_HEALTHY, BANK_QUARANTINED, BANK_PROBATION = \
    "healthy", "quarantined", "probation"


@dataclass
class _BankRecord:
    """One bank's health ledger (all counters all-time)."""

    state: str = BANK_HEALTHY
    score: float = 0.0                  # decaying error pressure
    errors: int = 0
    clean: int = 0
    probes: int = 0                     # clean tiles served this probation
    quarantines: int = 0
    release_vt: float = 0.0             # quarantine exit instant
    duration_vt: float = 0.0            # current quarantine length (doubles)


class BankHealth:
    """Per-bank error scoring, quarantine, and probation re-admission.

    Lifecycle per bank::

        HEALTHY --score >= error_threshold--> QUARANTINED
        QUARANTINED --vt >= release_vt------> PROBATION
        PROBATION --probation_tiles clean---> HEALTHY (duration resets)
        PROBATION --any error---------------> QUARANTINED (duration doubles)

    Quarantined banks are excluded from ``BankPool.try_place`` (the
    scheduler passes :meth:`ineligible` as the placement ``exclude`` set)
    and from the admission policy's occupancy denominator, so watermarks
    recompute against *surviving* capacity.  The doubling quarantine means
    a permanently dead bank asymptotically leaves the rotation while a
    transient victim is fully reinstated after a few clean probes.

    ``active`` gates all recording: a faults-off engine constructs the
    tracker but never charges it, keeping the hot path free (pinned by the
    golden byte-identity test)."""

    def __init__(self, n_banks: int, *, error_threshold: float = 3.0,
                 decay: float = 1.0, quarantine_vt: float = 4096.0,
                 probation_tiles: int = 3, active: bool = False):
        if n_banks < 1:
            raise ValueError("n_banks must be >= 1")
        if error_threshold < 1:
            raise ValueError("error_threshold must be >= 1")
        if probation_tiles < 1:
            raise ValueError("probation_tiles must be >= 1")
        self.error_threshold = float(error_threshold)
        self.decay = float(decay)
        self.quarantine_vt = float(quarantine_vt)
        self.probation_tiles = int(probation_tiles)
        self.active = bool(active)
        self.records = [_BankRecord() for _ in range(n_banks)]
        self._quarantined: set[int] = set()
        self.quarantines = 0            # total entries into quarantine
        self.probations = 0             # total entries into probation
        self.reinstated = 0             # total full re-admissions

    # ----------------------------------------------------------- transitions
    def _quarantine(self, index: int, vt: float) -> None:
        rec = self.records[index]
        rec.state = BANK_QUARANTINED
        rec.score = 0.0
        rec.probes = 0
        rec.duration_vt = (rec.duration_vt * 2.0 if rec.duration_vt > 0
                           else self.quarantine_vt)
        rec.release_vt = vt + rec.duration_vt
        rec.quarantines += 1
        self.quarantines += 1
        self._quarantined.add(index)

    def record_error(self, bank_ids, vt: float) -> list[int]:
        """Charge an execution fault to ``bank_ids``; returns the banks
        this error pushed into quarantine (the QUARANTINE trace instants)."""
        newly = []
        for i in bank_ids:
            rec = self.records[i]
            rec.errors += 1
            if rec.state == BANK_QUARANTINED:
                continue                # already out; blame-all overlap
            if rec.state == BANK_PROBATION:
                self._quarantine(i, vt)     # failed probe: doubled duration
                newly.append(i)
                continue
            rec.score += 1.0
            if rec.score >= self.error_threshold:
                self._quarantine(i, vt)
                newly.append(i)
        return newly

    def record_ok(self, bank_ids, vt: float) -> tuple[list[int], list[int]]:
        """Credit a clean execution; returns ``(probing, reinstated)`` —
        probation banks that served this tile (PROBE trace instants) and
        the subset that earned full reinstatement by it."""
        probing, reinstated = [], []
        for i in bank_ids:
            rec = self.records[i]
            rec.clean += 1
            if rec.state == BANK_PROBATION:
                rec.probes += 1
                probing.append(i)
                if rec.probes >= self.probation_tiles:
                    rec.state = BANK_HEALTHY
                    rec.score = 0.0
                    rec.probes = 0
                    rec.duration_vt = 0.0   # clean slate: base quarantine
                    self.reinstated += 1
                    reinstated.append(i)
            elif rec.state == BANK_HEALTHY and rec.score > 0:
                rec.score = max(0.0, rec.score - self.decay)
        return probing, reinstated

    # ------------------------------------------------------------ placement
    _EMPTY: frozenset = frozenset()

    def ineligible(self, vt: float) -> frozenset:
        """Banks excluded from placement at ``vt``.  Quarantined banks
        whose release instant has passed transition to probation here
        (lazily, on the placement path that would otherwise skip them)."""
        if not self._quarantined:
            return self._EMPTY
        for i in sorted(self._quarantined):
            rec = self.records[i]
            if vt >= rec.release_vt:
                rec.state = BANK_PROBATION
                rec.probes = 0
                self.probations += 1
                self._quarantined.discard(i)
        return frozenset(self._quarantined)

    def next_release_vt(self) -> float | None:
        """Earliest quarantine exit (None: nothing quarantined) — the
        wake-up instant for a queue stalled on surviving capacity."""
        if not self._quarantined:
            return None
        return min(self.records[i].release_vt for i in self._quarantined)

    # ------------------------------------------------------------ telemetry
    def section(self) -> dict:
        """The health half of the engine's ``fault`` telemetry section
        (fixed keys; every bank always present under ``per_bank``)."""
        return {
            "quarantines": self.quarantines,
            "probations": self.probations,
            "reinstated": self.reinstated,
            "quarantined_now": len(self._quarantined),
            "per_bank": {
                str(i): {"state": rec.state, "score": rec.score,
                         "errors": rec.errors, "clean": rec.clean,
                         "quarantines": rec.quarantines}
                for i, rec in enumerate(self.records)
            },
        }

    # ------------------------------------------------------------- rollback
    def snapshot(self) -> dict:
        return {
            "records": [copy.copy(vars(rec)) for rec in self.records],
            "quarantined": set(self._quarantined),
            "totals": (self.quarantines, self.probations, self.reinstated),
        }

    def restore(self, snap: dict) -> None:
        for rec, saved in zip(self.records, snap["records"]):
            vars(rec).update(saved)
        self._quarantined = set(snap["quarantined"])
        self.quarantines, self.probations, self.reinstated = snap["totals"]
