"""fleet — N engine replicas behind a telemetry-driven router.

The torch port of :mod:`repro.sortserve.fleet`, copied (it is
framework-free): the replicas are the port's engines, on whatever device
their configs name.  The warm-state artifact is the reference's format
and version, so an artifact written by either package loads in the other.

The paper's §IV multi-bank manager scales column-skipping across memory
banks inside one sorter; this module applies the same shape one level up
and scales across *engine replicas*.  A :class:`FleetRouter` owns N
:class:`~repro_torch.sortserve.engine.SortServeEngine` replicas and places each
request on the replica whose live signals say it will serve it soonest:

  * the sliding ``window.*`` telemetry section (queue depth, occupancy,
    shed rate — the same numbers ``telemetry()["window"]`` reports),
  * the per-traffic-class measured :class:`~repro_torch.sortserve.backends.
    CostPolicy` EMAs for the request's ``(op, N, k)`` signature, so a
    replica that has proven fast for this class's shapes wins ties.

Failure handling reuses the fault layer's degradation ladder at replica
granularity:

  * a hard execution failure fails the request over to a sibling replica
    (exactly-once: a failed request leaves the originating session
    entirely before it is re-fed) and charges the replica's
    :class:`~repro_torch.sortserve.faults.BankHealth` record — enough errors
    quarantine the replica, a quarantine expires into probation, clean
    probes reinstate it;
  * a :class:`~repro_torch.sortserve.scheduler.ShedError` from an overloaded
    replica *redirects* to a sibling with headroom instead of shedding,
    and puts the shedding replica on a ``RetryAfter``-derived cooldown;
    only when every eligible replica sheds does the fleet surface a
    :class:`FleetSaturated` (itself a ``RetryAfter``) to the caller.

Warm state rides along: a
versioned JSON artifact — per-traffic-class tile-signature menus, the
measured cost-EMA priors (class rows included), and calibration profile
rows — saved via :func:`save_warm_state` and restored via
:func:`load_warm_state` + :meth:`SortServeEngine.apply_warm_state`, so a
fresh replica joins the fleet with a prewarmed ``ExecutorCache`` and
warmed cost priors before its first request (maxtext's standalone
checkpointer is the exemplar: state save/restore decoupled from serving).

Fleet observability needs no new machinery: each replica's
``telemetry_snapshot()`` merges through the existing
:func:`repro_torch.obs.aggregate.merge_snapshots` path (counters sum, gauges
last-write-wins), and :meth:`FleetRouter.telemetry` adds a fixed-shape
``fleet.*`` section documented in ``docs/telemetry.md``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

from repro_torch.core.costmodel import BASE_CLOCK_MHZ
from repro_torch.obs.aggregate import TelemetrySnapshot, merge_snapshots

from .engine import RetryAfter, SortServeEngine
from .faults import BankHealth, _BankRecord
from .request import SortRequest, SortResponse
from .scheduler import ShedError

__all__ = [
    "FleetError",
    "FleetRouter",
    "FleetSaturated",
    "NoReplicaAvailable",
    "WARM_STATE_FORMAT",
    "WARM_STATE_VERSION",
    "WarmStateError",
    "load_warm_state",
    "merge_warm_states",
    "save_warm_state",
]


# --------------------------------------------------------------------------
# errors
# --------------------------------------------------------------------------
class FleetError(RuntimeError):
    """Base class for fleet-level routing failures."""


class NoReplicaAvailable(FleetError):
    """No eligible replica could serve the request: every candidate is
    quarantined, or every candidate that tried it failed hard.  The last
    underlying engine error is chained as ``__cause__``."""


class FleetSaturated(RetryAfter, FleetError):
    """Every eligible replica shed the request — fleet-wide overload.

    A :class:`~repro_torch.sortserve.engine.RetryAfter`: ``retry_after_s``
    carries the smallest live drain-time hint across the fleet, so a
    well-behaved client backs off exactly as it would against one
    overloaded engine."""


class WarmStateError(ValueError):
    """A warm-state artifact that cannot be applied: wrong format tag,
    version mismatch, corrupt JSON, or structurally invalid blocks.
    Deliberately a typed error — a bad artifact must never crash (or
    silently half-warm) a starting replica."""


# --------------------------------------------------------------------------
# warm-state artifact
# --------------------------------------------------------------------------
WARM_STATE_FORMAT = "sortserve-warm-state"
WARM_STATE_VERSION = 1

_PRIOR_KEYS = ("backend", "op", "n", "s_per_row", "samples")


def _canonical_json(payload: dict) -> str:
    return json.dumps(payload, indent=2, sort_keys=True) + "\n"


def save_warm_state(engine: SortServeEngine, path: str | None = None) -> dict:
    """Serialize an engine's warm state as the versioned artifact.

    The payload wraps :meth:`SortServeEngine.export_warm_state` (class
    signature menus, measured cost-EMA priors including per-class rows,
    calibration profile rows) in a ``{format, version}`` envelope.  When
    ``path`` is given the artifact is written as canonical JSON (sorted
    keys, 2-space indent, trailing newline) so ``save -> load -> save``
    round-trips byte-identically."""
    payload = {"format": WARM_STATE_FORMAT, "version": WARM_STATE_VERSION,
               **engine.export_warm_state()}
    if path is not None:
        with open(path, "w") as f:
            f.write(_canonical_json(payload))
    return payload


def load_warm_state(source) -> dict:
    """Read and validate a warm-state artifact.

    ``source`` is a filesystem path or an already-parsed payload dict.
    Returns the validated payload; raises :class:`WarmStateError` on
    corrupt JSON, a wrong ``format`` tag, a ``version`` this build does
    not speak, or structurally invalid menu/prior/calibration blocks.
    Apply the result with :meth:`SortServeEngine.apply_warm_state` or
    :meth:`FleetRouter.load_warm_state`."""
    if isinstance(source, dict):
        payload = source
    else:
        try:
            with open(source) as f:
                text = f.read()
        except OSError as exc:
            raise WarmStateError(f"cannot read warm state {source!r}: {exc}") \
                from exc
        try:
            payload = json.loads(text)
        except ValueError as exc:
            raise WarmStateError(
                f"corrupt warm-state JSON in {source!r}: {exc}") from exc
    _validate_warm_state(payload)
    return payload


def _validate_warm_state(payload) -> None:
    if not isinstance(payload, dict):
        raise WarmStateError(f"warm state must be a JSON object, "
                             f"got {type(payload).__name__}")
    fmt = payload.get("format")
    if fmt != WARM_STATE_FORMAT:
        raise WarmStateError(f"not a warm-state artifact: format={fmt!r} "
                             f"(expected {WARM_STATE_FORMAT!r})")
    version = payload.get("version")
    if version != WARM_STATE_VERSION:
        raise WarmStateError(f"warm-state version {version!r} not supported "
                             f"(this build speaks {WARM_STATE_VERSION})")
    menus = payload.get("menus", {})
    if not isinstance(menus, dict):
        raise WarmStateError("warm-state 'menus' must be an object")
    for cls, menu in menus.items():
        if not isinstance(menu, list):
            raise WarmStateError(f"menu for class {cls!r} must be a list")
        for sig in menu:
            if not isinstance(sig, (list, tuple)) or len(sig) != 5:
                raise WarmStateError(f"malformed signature {sig!r} in "
                                     f"class {cls!r} (want [op,B,N,k,hint])")
    priors = payload.get("priors", [])
    if not isinstance(priors, list):
        raise WarmStateError("warm-state 'priors' must be a list")
    for row in priors:
        if not isinstance(row, dict) or \
                any(key not in row for key in _PRIOR_KEYS):
            raise WarmStateError(f"malformed prior row {row!r} "
                                 f"(want keys {_PRIOR_KEYS})")
    calib = payload.get("calibration", [])
    if not isinstance(calib, list) or any(
            not isinstance(row, dict) for row in calib):
        raise WarmStateError("warm-state 'calibration' must be a list of "
                             "row objects")


def merge_warm_states(payloads) -> dict:
    """Fold several warm-state payloads into one fleet-wide artifact.

    Menus union per class; priors for the same ``(backend, op, n, k,
    traffic_class)`` signature combine as the sample-weighted mean of
    their EMAs (samples sum); calibration cells for the same ``(backend,
    width)`` sum their tile/wall/cycle accumulators, with the measured/
    modeled ratio recomputed at the default modeled clock."""
    payloads = [load_warm_state(p) for p in payloads]
    if not payloads:
        return {"format": WARM_STATE_FORMAT, "version": WARM_STATE_VERSION,
                "menus": {}, "priors": [], "calibration": []}
    menus: dict[str, set] = {}
    priors: dict[tuple, dict] = {}
    calib: dict[tuple, dict] = {}
    clock_hz = BASE_CLOCK_MHZ * 1e6
    for payload in payloads:
        for cls, menu in payload.get("menus", {}).items():
            dest = menus.setdefault(str(cls), set())
            dest.update(tuple(sig) for sig in menu)
        for row in payload.get("priors", []):
            key = (row["backend"], row["op"], int(row["n"]), row.get("k"),
                   row.get("traffic_class"))
            samples = max(1, int(row.get("samples", 1)))
            prev = priors.get(key)
            if prev is None:
                priors[key] = {"s_per_row": float(row["s_per_row"]),
                               "samples": samples}
            else:
                total = prev["samples"] + samples
                prev["s_per_row"] = (
                    prev["s_per_row"] * prev["samples"]
                    + float(row["s_per_row"]) * samples) / total
                prev["samples"] = total
        for row in payload.get("calibration", []):
            key = (row["backend"], int(row["width"]))
            cell = calib.setdefault(key, {"tiles": 0, "wall_s": 0.0,
                                          "modeled_cycles": 0})
            cell["tiles"] += int(row.get("tiles", 0))
            cell["wall_s"] += float(row.get("wall_s", 0.0))
            cell["modeled_cycles"] += int(row.get("modeled_cycles", 0))
    prior_rows = []
    for key in sorted(priors, key=repr):
        backend, op, n, k, cls = key
        prior_rows.append({"backend": backend, "op": op, "n": n, "k": k,
                           "s_per_row": priors[key]["s_per_row"],
                           "samples": priors[key]["samples"],
                           "traffic_class": cls})
    calib_rows = []
    for (backend, width) in sorted(calib):
        cell = calib[(backend, width)]
        modeled_s = cell["modeled_cycles"] / clock_hz
        calib_rows.append({"backend": backend, "width": width,
                           "tiles": cell["tiles"],
                           "wall_s": cell["wall_s"],
                           "modeled_cycles": cell["modeled_cycles"],
                           "ratio": (cell["wall_s"] / modeled_s
                                     if modeled_s > 0 else 0.0)})
    return {"format": WARM_STATE_FORMAT, "version": WARM_STATE_VERSION,
            "menus": {cls: sorted([list(sig) for sig in sigs], key=repr)
                      for cls, sigs in sorted(menus.items())},
            "priors": prior_rows, "calibration": calib_rows}


# --------------------------------------------------------------------------
# replica slot
# --------------------------------------------------------------------------
class _Replica:
    """One fleet slot: the live engine plus the slot's routing state.

    Counters are per *slot*, not per engine object — a rolling restart
    swaps the engine but the slot's routed/served history describes the
    position in the fleet, which is what the operator watches."""

    def __init__(self, index: int, name: str, engine: SortServeEngine):
        self.index = index
        self.name = name
        self.engine = engine
        self.sessions: dict = {}        # traffic_class -> SortSession
        self.routed = 0
        self.served = 0
        self.failed = 0
        self.shed = 0
        self.selections = 0             # placement tie-break (least-placed)
        self.cooldown_until = float("-inf")

    def session(self, traffic_class):
        sess = self.sessions.get(traffic_class)
        if sess is None:
            sess = self.engine.begin(strict=False,
                                     traffic_class=traffic_class)
            self.sessions[traffic_class] = sess
        return sess

    def swap_engine(self, engine: SortServeEngine) -> None:
        self.engine = engine
        self.sessions = {}
        self.cooldown_until = float("-inf")

    def signals(self, now: float) -> dict:
        """The live ``window.*`` placement signal, under the engine lock."""
        eng = self.engine
        with eng._lock:
            w = eng._metrics.window(now, eng.scheduler.queue_depth())
            w["retry_after_s"] = eng._retry_after_at(now)
        return w


# --------------------------------------------------------------------------
# the router
# --------------------------------------------------------------------------
class FleetRouter:
    """Spread requests across N engine replicas by live telemetry.

    ``engines`` seeds the fleet; ``engine_factory`` (optional) builds a
    fresh engine for :meth:`restart` when the caller does not supply one.
    ``seed`` drives the deterministic tie-break jitter — two routers with
    the same seed serving the same trace place every request identically.
    ``clock`` defaults to ``time.perf_counter`` and times quarantine and
    cooldown windows; pass the engines' fake clock in tests so both
    domains advance together.

    Replica health is a :class:`~repro_torch.sortserve.faults.BankHealth` at
    replica granularity: ``error_threshold`` hard failures quarantine a
    replica for ``quarantine_s`` (doubling on re-offense), an expired
    quarantine becomes probation, and ``probation_requests`` clean
    requests reinstate it.  Quarantined replicas receive no traffic;
    probation replicas serve (their requests are the probes)."""

    def __init__(self, engines, *, engine_factory=None, names=None,
                 seed: int = 0, clock=None, error_threshold: float = 2.0,
                 quarantine_s: float = 0.5, probation_requests: int = 2):
        engines = list(engines)
        if not engines:
            raise ValueError("a fleet needs at least one replica")
        if names is None:
            names = [f"replica{i}" for i in range(len(engines))]
        if len(names) != len(engines) or len(set(names)) != len(names):
            raise ValueError("names must be unique, one per engine")
        self.replicas = [_Replica(i, nm, eng)
                         for i, (nm, eng) in enumerate(zip(names, engines))]
        self.engine_factory = engine_factory
        self.seed = int(seed)
        self._clock = time.perf_counter if clock is None else clock
        # deterministic tie-break stream: one draw per candidate per
        # placement, so equal scores split reproducibly given the seed
        import random
        self._rng = random.Random(self.seed)
        self._lock = threading.RLock()
        self._health = BankHealth(len(engines), active=True,
                                  error_threshold=error_threshold,
                                  decay=1.0,
                                  quarantine_vt=float(quarantine_s),
                                  probation_tiles=int(probation_requests))
        self._counters = {"requests": 0, "served": 0, "failed": 0,
                          "shed": 0, "failovers": 0, "redirects": 0,
                          "restarts": 0}
        self._retired: list[TelemetrySnapshot] = []
        # placement order (replica index per routed request, failovers
        # included) — the determinism property test compares these
        self.route_log: deque = deque(maxlen=65536)

    # ------------------------------------------------------------ placement
    def select(self, *, op: str | None = None, n: int | None = None,
               k: int | None = None, traffic_class: str | None = None,
               now: float | None = None, exclude=()) -> int:
        """Pick the replica the fleet would place this request on.

        Raises :class:`NoReplicaAvailable` when every replica is
        quarantined or excluded.  Public so harnesses (the fleet rows in
        ``benchmarks/streaming_bench.py``) can drive placement while
        simulating service in the §V cycle domain."""
        with self._lock:
            now = self._clock() if now is None else now
            i = self._select(now, op, n, k, traffic_class, set(exclude))
            if i is None:
                raise NoReplicaAvailable(
                    "no eligible replica (all quarantined or excluded)")
            return i

    def _select(self, now, op, n, k, traffic_class, exclude, placed=None):
        quarantined = self._health.ineligible(now)
        cands = [rep for rep in self.replicas
                 if rep.index not in quarantined and rep.index not in exclude]
        if not cands:
            return None
        loads, costs = {}, {}
        for rep in cands:
            # window signals in the engine's own clock domain (the router
            # clock may be a test double timing only health/cooldowns);
            # `placed` counts this batch round's earlier placements — work
            # already bound for the replica that its window cannot show
            # yet, without which a whole round piles onto one replica
            w = rep.signals(rep.engine._clock())
            loads[rep.index] = (w["queue_depth"] + w["occupancy"]
                                + 4.0 * w["shed_rate"]
                                + (placed.get(rep.index, 0) if placed else 0))
            costs[rep.index] = self._class_cost(rep, op, n, k, traffic_class)
        known = [c for c in costs.values() if c is not None]
        floor = min(known) if known else None
        best, best_key = None, None
        for rep in cands:
            cost = costs[rep.index]
            factor = (cost / floor if cost is not None and floor else 1.0)
            score = (loads[rep.index] + 1.0) * factor
            if now < rep.cooldown_until:
                score += 1e9            # shedding recently: last resort only
            key = (score, rep.selections, self._rng.random())
            if best_key is None or key < best_key:
                best, best_key = rep, key
        best.selections += 1
        return best.index

    def _class_cost(self, rep, op, n, k, traffic_class):
        """Best measured s/row across the replica's capable backends for
        this signature (class EMA first, global fallback), or None."""
        if op is None or n is None:
            return None
        policy = rep.engine.policy
        emas = [policy.measured_s_per_row(b.name, op, int(n), k,
                                          traffic_class)
                for b in rep.engine.backends if op in b.ops]
        emas = [e for e in emas if e is not None]
        return min(emas) if emas else None

    # -------------------------------------------------------------- serving
    def serve(self, requests, traffic_class: str | None = None,
              now: float | None = None):
        """Serve a batch with failover; never raises for per-request
        failures.

        Returns ``(responses, failures)``: ``responses`` aligns with the
        input order (``None`` where a request failed fleet-wide), and
        ``failures`` is ``[(request, exc), ...]`` where every ``exc`` is
        typed — :class:`FleetSaturated` when every eligible replica shed
        it, :class:`NoReplicaAvailable` (with the engine error chained)
        otherwise.  Every request is served exactly once or appears in
        ``failures`` exactly once: a request that fails on a replica has
        left that replica's session entirely before it is re-placed."""
        requests = list(requests)
        rids = [req.request_id for req in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("duplicate request_id in fleet batch")
        with self._lock:
            now = self._clock() if now is None else now
            self._counters["requests"] += len(requests)
            results: dict[int, SortResponse] = {}
            failures: dict[int, Exception] = {}
            state = {req.request_id: {"req": req, "tried": set(),
                                      "sheds": 0, "errors": 0,
                                      "last_exc": None}
                     for req in requests}
            pending = list(requests)
            for _ in range(2 * len(self.replicas) + 2):
                if not pending:
                    break
                pending = self._serve_round(pending, traffic_class, now,
                                            state, results, failures)
            for req in pending:         # bounded loop safety net
                failures.setdefault(
                    req.request_id,
                    self._failure_for(state[req.request_id], now))
            responses = [results.get(rid) for rid in rids]
            fail_list = [(state[rid]["req"], failures[rid])
                         for rid in rids if rid in failures]
            return responses, fail_list

    def _serve_round(self, pending, traffic_class, now, state, results,
                     failures):
        assign: dict[int, list] = {}
        placed: dict[int, int] = {}
        for req in pending:
            st = state[req.request_id]
            i = self._select(now, req.op, req.n, req.k, traffic_class,
                             st["tried"], placed)
            if i is None:
                exc = self._failure_for(st, now)
                failures[req.request_id] = exc
                continue
            assign.setdefault(i, []).append(req)
            placed[i] = placed.get(i, 0) + 1
            self.route_log.append(i)
            self.replicas[i].routed += 1
        next_pending = []
        for i in sorted(assign):
            rep = self.replicas[i]
            sess = rep.session(traffic_class)
            got = sess.feed(assign[i], flush=True)
            fails = sess.take_failures()
            for resp in got:
                results[resp.request_id] = resp
                rep.served += 1
                self._counters["served"] += 1
                self._note_ok(i, now)
            for req, exc, _co in fails:
                st = state[req.request_id]
                st["tried"].add(i)
                if isinstance(exc, ShedError):
                    st["sheds"] += 1
                    rep.shed += 1
                    rep.cooldown_until = max(
                        rep.cooldown_until,
                        now + rep.engine.retry_after_s())
                else:
                    st["errors"] += 1
                    st["last_exc"] = exc
                    rep.failed += 1
                    self._health.record_error([i], now)
                if self._has_untried(st["tried"], now):
                    if isinstance(exc, ShedError):
                        self._counters["redirects"] += 1
                    else:
                        self._counters["failovers"] += 1
                    next_pending.append(req)
                else:
                    failures[req.request_id] = self._failure_for(st, now)
        return next_pending

    def _has_untried(self, tried, now) -> bool:
        quarantined = self._health.ineligible(now)
        return any(rep.index not in tried and rep.index not in quarantined
                   for rep in self.replicas)

    def _note_ok(self, index: int, now: float) -> None:
        self._health.record_ok([index], now)

    def _failure_for(self, st, now) -> Exception:
        if st["errors"] == 0 and st["sheds"] > 0:
            self._counters["shed"] += 1
            hint = min(rep.engine.retry_after_s()
                       for rep in self.replicas)
            return FleetSaturated(
                f"request {st['req'].request_id} shed by every eligible "
                f"replica ({st['sheds']} sheds)", retry_after_s=hint)
        self._counters["failed"] += 1
        exc = NoReplicaAvailable(
            f"request {st['req'].request_id} exhausted the fleet "
            f"({st['errors']} hard failures, {st['sheds']} sheds)")
        exc.__cause__ = st["last_exc"]
        return exc

    def submit(self, requests, traffic_class: str | None = None,
               now: float | None = None):
        """Strict batch serve: responses align with the input order;
        the first fleet-wide failure raises its typed error."""
        responses, fail_list = self.serve(requests, traffic_class, now)
        if fail_list:
            raise fail_list[0][1]
        return responses

    # -------------------------------------------------------------- restart
    def restart(self, index: int, engine: SortServeEngine | None = None, *,
                warm_state=None, now: float | None = None) -> dict:
        """Rolling-restart one slot: retire the live engine (its telemetry
        snapshot is kept so fleet aggregation never loses history), swap
        in a fresh engine (``engine`` or ``engine_factory()``), apply a
        warm-state artifact when given, and reset the slot's health record
        — a fresh replica starts healthy.  Returns the
        ``apply_warm_state`` stats (all-zero when no warm state given)."""
        with self._lock:
            now = self._clock() if now is None else now
            rep = self.replicas[index]
            if engine is None:
                if self.engine_factory is None:
                    raise ValueError("restart needs an engine or an "
                                     "engine_factory")
                engine = self.engine_factory()
            n_retired = len(self._retired)
            self._retired.append(rep.engine.telemetry_snapshot(
                source=f"{rep.name}@retired{n_retired}"))
            rep.swap_engine(engine)
            self._reset_health(index)
            self._counters["restarts"] += 1
            stats = {"classes": 0, "signatures": 0, "priors": 0,
                     "calibration": 0, "prewarmed": 0}
            if warm_state is not None:
                stats = engine.apply_warm_state(load_warm_state(warm_state))
            return stats

    def _reset_health(self, index: int) -> None:
        snap = self._health.snapshot()
        snap["records"][index] = dict(vars(_BankRecord()))
        snap["quarantined"].discard(index)
        self._health.restore(snap)

    # ----------------------------------------------------------- warm state
    def save_warm_state(self, path: str | None = None) -> dict:
        """The fleet-wide artifact: every live replica's warm state merged
        (:func:`merge_warm_states`), optionally written as canonical
        JSON."""
        with self._lock:
            payload = merge_warm_states(
                [save_warm_state(rep.engine) for rep in self.replicas])
        if path is not None:
            with open(path, "w") as f:
                f.write(_canonical_json(payload))
        return payload

    def load_warm_state(self, source) -> dict:
        """Apply one artifact to every live replica; returns summed
        ``apply_warm_state`` stats."""
        payload = load_warm_state(source)
        with self._lock:
            totals = {"classes": 0, "signatures": 0, "priors": 0,
                      "calibration": 0, "prewarmed": 0}
            for rep in self.replicas:
                stats = rep.engine.apply_warm_state(payload)
                for key in totals:
                    totals[key] += stats[key]
            return totals

    # ------------------------------------------------------------ telemetry
    def telemetry(self) -> dict:
        """The fixed-shape ``fleet.*`` section (``docs/telemetry.md``)."""
        with self._lock:
            now = self._clock()
            quarantined = self._health.ineligible(now)
            health = self._health.section()
            per_replica = {}
            for rep in self.replicas:
                w = rep.signals(rep.engine._clock())
                per_replica[rep.name] = {
                    "state": health["per_bank"][str(rep.index)]["state"],
                    "routed": rep.routed,
                    "served": rep.served,
                    "failed": rep.failed,
                    "shed": rep.shed,
                    "cooldown_s": max(0.0, rep.cooldown_until - now),
                    "queue_depth": w["queue_depth"],
                    "occupancy": w["occupancy"],
                    "shed_rate": w["shed_rate"],
                    "tiles_per_s": w["tiles_per_s"],
                    "retry_after_s": w["retry_after_s"],
                }
            return {
                "replicas": len(self.replicas),
                "eligible": len(self.replicas) - len(quarantined),
                **dict(self._counters),
                "health": {
                    "quarantines": health["quarantines"],
                    "probations": health["probations"],
                    "reinstated": health["reinstated"],
                    "quarantined_now": health["quarantined_now"],
                },
                "per_replica": per_replica,
            }

    def snapshot(self, include_retired: bool = True) -> TelemetrySnapshot:
        """The fleet's mergeable telemetry: every live replica's raw
        snapshot — plus retired engines' final snapshots, so a rolling
        restart never loses served-request history — folded through
        :func:`repro_torch.obs.aggregate.merge_snapshots` (counters sum,
        gauges last-write-wins)."""
        with self._lock:
            snaps = list(self._retired) if include_retired else []
            snaps += [rep.engine.telemetry_snapshot(source=rep.name)
                      for rep in self.replicas]
            return merge_snapshots(snaps)

    def dump_snapshot(self, path: str) -> TelemetrySnapshot:
        snap = self.snapshot()
        snap.dump(path)
        return snap
