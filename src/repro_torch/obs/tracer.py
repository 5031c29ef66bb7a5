"""Flight-recorder span tracing for the serving stack.

One :class:`Tracer` records one **span chain per request** —

    feed -> bucket -> admit -> execute -> scatter -> retire

— in *both* time domains at once: wall seconds on the engine's injectable
clock (feed/dispatch/execute/retire stamps) and virtual time in modeled
hardware cycles from the :class:`~repro_torch.sortserve.scheduler
.ContinuousScheduler` event clock (arrive/admit/early/retire events, bank
placement, queue wait).  Scheduler events (ARRIVE / ADMIT / DEFER / SHED /
EARLY / RETIRE) are emitted into the same stream via the scheduler's
``on_event`` hook, so a request's wall-clock story and its tile's
event-clock story stay joined by construction.  Fault-recovery events
(RETRY / QUARANTINE / PROBE, emitted by the scheduler under
``EngineConfig(faults=...)`` — see ``docs/robustness.md``) ride the same
hook: unknown kinds render as instants on the scheduler-event track, so
the recovery story of a retried tile sits inline with its admissions.

Design constraints, in order:

  * **Low overhead** — every hook is a handful of dict writes under the
    engine lock; no formatting, no I/O, no clock reads of its own (every
    wall stamp is passed in from the engine's clock, so traces are
    deterministic under a fake clock).
  * **Bounded memory** — finished request chains and retired tile records
    land in rings (``deque(maxlen=capacity)``); the recorder forgets the
    old past, never grows without bound.  Flight-recorder semantics also
    mean the trace is *exempt from submit rollback*: a failed batch rolls
    back telemetry counters, but what the recorder saw, it keeps (like the
    executor cache keeps its compiles).
  * **Off by default** — the engine only calls these hooks when a tracer
    was injected via ``EngineConfig(tracer=...)``; without one, the serving
    path is untouched.

:meth:`Tracer.export` renders the recording as Chrome trace-event JSON
(``chrome://tracing`` / https://ui.perfetto.dev): process 1 is the wall
domain (one track per request), process 2 is the virtual-time domain at the
modeled clock (one track per bank, plus a scheduler-event track), so both
domains sit in one viewer, zoomable together.
"""

from __future__ import annotations

import itertools
import json
from collections import deque

from repro_torch.core.costmodel import BASE_CLOCK_MHZ

__all__ = ["Tracer"]

# statuses a finalized request chain can carry
SERVED, CACHE_HIT, SHED, FAILED, ABORTED = (
    "served", "cache_hit", "shed", "failed", "aborted")

# hot-path templates: one C-level ``dict.copy`` beats rebuilding the
# full literal on every request/tile (these hooks run inside the engine
# lock on the serving fast path — see the 5% overhead gate in
# benchmarks/streaming_bench.py)
_CHAIN_TEMPLATE = {
    "rid": None, "op": None, "n": None, "traffic_class": None,
    "t_feed": None, "t_bucket": None, "t_done": None,
    "status": None, "latency_s": None, "tile": None,
}
_RECORD_TEMPLATE = {
    "seq": None, "op": None, "shape": None, "requests": None,
    "t_dispatch": None,
    "arrive_vt": None, "admit_vt": None, "retire_vt": None,
    "defers": 0, "bank_ids": None, "waves": 1, "early_banks": (),
    "duration_vt": None, "total_cycles": None,
    "backend": None, "exec_warm": None,
    "t_exec0": None, "t_exec1": None, "estimated_cycles": None,
    "status": None,
}


class Tracer:
    """Ring-buffered span recorder; inject via ``EngineConfig(tracer=...)``.

    ``capacity`` bounds both rings (finished request chains, retired tile
    records) and the scheduler-event ring; ``clock_hz`` maps virtual-time
    cycles onto export microseconds (default: the modeled 500 MHz part).
    """

    def __init__(self, capacity: int = 4096,
                 clock_hz: float = BASE_CLOCK_MHZ * 1e6):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if clock_hz <= 0:
            raise ValueError("clock_hz must be positive")
        self.capacity = int(capacity)
        self.clock_hz = float(clock_hz)
        self.chains: deque = deque(maxlen=capacity)   # finalized request chains
        self.tiles: deque = deque(maxlen=capacity)    # finished tile records
        # scheduler instants, stored raw as (kind, seq, vt, attrs) tuples —
        # the ``events`` property materializes dict views on demand
        self._events: deque = deque(maxlen=capacity)
        self._active: dict[int, dict] = {}            # rid -> open chain
        self._open_tiles: dict[int, dict] = {}        # seq -> open record
        self._seq = itertools.count(1)
        # Chain/record dicts are preallocated here and recycled through
        # freelists when the rings wrap, so recording allocates (almost)
        # nothing on the serving path: the pool promotes to the old GC
        # generation once and young-gen collections never see recorder
        # garbage again — the measured lever behind the 5% overhead gate
        # in benchmarks/streaming_bench.py.  Consequence (flight-recorder
        # semantics): a reference held to an evicted chain/record sees it
        # overwritten with newer data once the ring wraps.
        self._chain_free = [dict(_CHAIN_TEMPLATE) for _ in range(capacity)]
        self._record_free = [dict(_RECORD_TEMPLATE) for _ in range(capacity)]

    @property
    def events(self) -> list[dict]:
        """Scheduler-event ring as dicts (``kind`` / ``seq`` / ``vt`` +
        per-event attrs).  Materialized on access; the hot path stores raw
        tuples."""
        return [{"kind": kind, "seq": seq, "vt": vt, **attrs}
                for kind, seq, vt, attrs in self._events]

    # ----------------------------------------------------- allocation reuse
    def _new_chain(self) -> dict:
        free = self._chain_free
        if free:
            chain = free.pop()
            chain.update(_CHAIN_TEMPLATE)
            return chain
        return _CHAIN_TEMPLATE.copy()

    def _seal_chain(self, chain: dict) -> None:
        chains = self.chains
        if len(chains) == self.capacity:        # wrap: recycle the evictee
            self._chain_free.append(chains.popleft())
        chains.append(chain)

    # ------------------------------------------------------------- requests
    def request_feed(self, rid: int, op: str, n: int,
                     traffic_class: str | None, wall: float) -> None:
        """A request entered a session (post-validation, pre-bucket)."""
        chain = self._new_chain()
        chain["rid"] = rid
        chain["op"] = op
        chain["n"] = n
        chain["traffic_class"] = traffic_class
        chain["t_feed"] = wall
        self._active[rid] = chain

    def request_cache_hit(self, rid: int, op: str, n: int,
                          traffic_class: str | None, wall: float) -> None:
        """A request served from the result memo: a complete, tile-less
        chain whose whole life is one instant."""
        chain = self._new_chain()
        chain["rid"] = rid
        chain["op"] = op
        chain["n"] = n
        chain["traffic_class"] = traffic_class
        chain["t_feed"] = chain["t_bucket"] = chain["t_done"] = wall
        chain["status"] = CACHE_HIT
        chain["latency_s"] = 0.0
        self._seal_chain(chain)

    def request_dispatched(self, rid: int, record: dict, wall: float) -> None:
        """The request's bucket closed into a tile (the bucket-span end)."""
        chain = self._active.get(rid)
        if chain is not None:
            chain["t_bucket"] = wall
            chain["tile"] = record

    def request_done(self, rid: int, wall: float, latency_s: float) -> None:
        # inlined _finalize: this is the per-served-request fast path
        chain = self._active.pop(rid, None)
        if chain is not None:
            chain["t_done"] = wall
            chain["status"] = SERVED
            chain["latency_s"] = latency_s
            self._seal_chain(chain)

    def request_failed(self, rid: int, wall: float, status: str) -> None:
        self._finalize(rid, wall, status, None)

    def drop(self, rids, wall: float) -> None:
        """Abort path (rolled-back submit): finalize, don't forget — the
        recorder's job is precisely to remember what went wrong."""
        for rid in list(rids):
            self._finalize(rid, wall, ABORTED, None)

    def _finalize(self, rid: int, wall: float, status: str,
                  latency_s: float | None) -> None:
        chain = self._active.pop(rid, None)
        if chain is None:
            return
        chain["t_done"] = wall
        chain["status"] = status
        chain["latency_s"] = latency_s
        self._seal_chain(chain)

    # ---------------------------------------------------------------- tiles
    def tile_dispatched(self, tile, wall: float) -> dict:
        """Open a tile record and tag the tile so scheduler events and the
        execute hook find it back (``tile.obs["trace_seq"]``)."""
        seq = next(self._seq)
        tile.obs["trace_seq"] = seq
        free = self._record_free
        if free:
            record = free.pop()
            record.update(_RECORD_TEMPLATE)
        else:
            record = _RECORD_TEMPLATE.copy()
        record["seq"] = seq
        record["op"] = tile.op
        record["shape"] = tuple(tile.shape)
        record["requests"] = len(tile.entries)
        record["t_dispatch"] = wall
        open_tiles = self._open_tiles
        open_tiles[seq] = record
        while len(open_tiles) > self.capacity:   # abort-path leftovers
            del open_tiles[next(iter(open_tiles))]    # oldest (insert order)
        return record

    def tile_executed(self, tile, backend: str, warm, wall0: float,
                      wall1: float, cycles, estimated) -> None:
        record = self._open_tiles.get(tile.obs.get("trace_seq"))
        if record is None:
            return
        record["backend"] = backend
        record["exec_warm"] = warm
        record["t_exec0"] = wall0
        record["t_exec1"] = wall1
        record["total_cycles"] = cycles
        record["estimated_cycles"] = estimated

    # ----------------------------------------------------- scheduler stream
    def alert(self, vt: float, wall: float, traffic_class: str, sli: str,
              burn_long: float, burn_short: float) -> None:
        """An SLO burn-rate alert fired (:mod:`repro_torch.obs.slo`): recorded as
        an ALERT instant in the scheduler-event ring, so the page-worthy
        moment is visible on the same track as the ARRIVE/SHED story that
        caused it.  ``seq`` is 0 — alerts are per (class, SLI), not per
        tile."""
        self._events.append(("alert", 0, vt,
                             {"wall": wall, "traffic_class": traffic_class,
                              "sli": sli, "burn_long": burn_long,
                              "burn_short": burn_short}))

    def sched_event(self, kind: str, tile, vt: float, **attrs) -> None:
        """The scheduler's ``on_event`` hook: ARRIVE / ADMIT / DEFER / SHED
        / EARLY / RETIRE land in one ring, and terminal events close the
        tile's record into the tile ring."""
        seq = tile.obs.get("trace_seq")
        if seq is None:
            return                      # tile fed outside a traced engine
        self._events.append((kind, seq, vt, attrs))
        record = self._open_tiles.get(seq)
        if record is None:
            return
        if kind == "arrive":
            record["arrive_vt"] = vt
        elif kind == "defer":
            record["defers"] += 1
        elif kind == "admit":
            record["admit_vt"] = vt
            record["bank_ids"] = list(attrs.get("bank_ids", ()))
            record["waves"] = attrs.get("waves", 1)
        elif kind == "early":
            record["early_banks"] = tuple(attrs.get("bank_ids", ()))
        elif kind in ("retire", "shed", "exec_fail"):
            if kind == "retire":
                record["retire_vt"] = vt
                record["duration_vt"] = attrs.get("duration_vt")
                record["early_banks"] = tuple(attrs.get("early_banks", ())) \
                    or record["early_banks"]
            record["status"] = "retired" if kind == "retire" else kind
            self._open_tiles.pop(seq, None)
            tiles = self.tiles
            if len(tiles) == self.capacity:
                # wrap: recycle the evictee.  Chains wrap ``tile_rows``×
                # faster than tile records, so any chain that referenced
                # this record left its ring long ago.
                self._record_free.append(tiles.popleft())
            tiles.append(record)

    # ---------------------------------------------------------------- views
    def chain_for(self, rid: int) -> dict | None:
        """Most recent finalized chain for a request id (tests/tools)."""
        for chain in reversed(self.chains):
            if chain["rid"] == rid:
                return chain
        return None

    def span_count(self) -> int:
        return len(self.chains)

    # --------------------------------------------------------------- export
    def export(self, bank_labels=None) -> dict:
        """Render the recording as a Chrome trace-event document.

        pid 1: the wall domain — one thread per request id, nested complete
        spans (``request`` ⊃ ``bucket`` / ``admit`` / ``execute`` /
        ``scatter``) with the virtual-time story attached as span args.
        pid 2: the virtual-time domain mapped at ``clock_hz`` — one thread
        per bank (labelled via ``bank_labels``, device-aware on a mesh
        pool) carrying tile occupancy spans, plus one scheduler-event
        thread of ARRIVE/ADMIT/DEFER/SHED/EARLY/RETIRE instants.
        """
        ev: list[dict] = []
        us_per_cycle = 1e6 / self.clock_hz
        labels = list(bank_labels or ())
        sched_tid = len(labels) or 64    # one past the last bank track
        ev.append({"name": "process_name", "ph": "M", "pid": 1,
                   "args": {"name": "requests (wall clock)"}})
        ev.append({"name": "process_name", "ph": "M", "pid": 2,
                   "args": {"name": f"banks (virtual time @ "
                                    f"{self.clock_hz / 1e6:.0f} MHz)"}})
        for i, label in enumerate(labels):
            ev.append({"name": "thread_name", "ph": "M", "pid": 2, "tid": i,
                       "args": {"name": label}})
        ev.append({"name": "thread_name", "ph": "M", "pid": 2,
                   "tid": sched_tid, "args": {"name": "scheduler events"}})

        chains = list(self.chains)
        t0 = min((c["t_feed"] for c in chains), default=0.0)

        def us(wall: float) -> float:
            return (wall - t0) * 1e6

        def x(name, pid, tid, ts, dur, args):
            ev.append({"name": name, "ph": "X", "pid": pid, "tid": tid,
                       "ts": ts, "dur": max(dur, 0.0), "cat": "sortserve",
                       "args": args})

        for c in chains:
            rec = c["tile"] or {}
            vt_args = {k: rec.get(k) for k in
                       ("arrive_vt", "admit_vt", "retire_vt", "defers")}
            x(f"request {c['op']} n={c['n']}", 1, c["rid"],
              us(c["t_feed"]), us(c["t_done"]) - us(c["t_feed"]),
              {"rid": c["rid"], "op": c["op"], "n": c["n"],
               "status": c["status"], "latency_s": c["latency_s"],
               "traffic_class": c["traffic_class"], **vt_args})
            if c["status"] == CACHE_HIT or c["t_bucket"] is None:
                continue
            t_exec0, t_exec1 = rec.get("t_exec0"), rec.get("t_exec1")
            x("bucket", 1, c["rid"], us(c["t_feed"]),
              us(c["t_bucket"]) - us(c["t_feed"]),
              {"tile_seq": rec.get("seq"), "shape": list(rec.get("shape", ())),
               "co_batched": rec.get("requests")})
            if t_exec0 is None:        # shed / failed before execution
                continue
            x("admit", 1, c["rid"], us(c["t_bucket"]),
              us(t_exec0) - us(c["t_bucket"]),
              {"bank_ids": rec.get("bank_ids"), "waves": rec.get("waves"),
               "defers": rec.get("defers"),
               "queue_wait_vt": (None if rec.get("admit_vt") is None
                                 or rec.get("arrive_vt") is None else
                                 rec["admit_vt"] - rec["arrive_vt"])})
            x("execute", 1, c["rid"], us(t_exec0), us(t_exec1) - us(t_exec0),
              {"backend": rec.get("backend"), "warm": rec.get("exec_warm"),
               "cycles": rec.get("total_cycles"),
               "estimated_cycles": rec.get("estimated_cycles"),
               "wall_s": t_exec1 - t_exec0})
            x("scatter", 1, c["rid"], us(t_exec1),
              us(c["t_done"]) - us(t_exec1), {})

        for rec in self.tiles:
            if rec.get("admit_vt") is None or rec.get("duration_vt") is None:
                continue               # shed / failed: never occupied banks
            early = set(rec["early_banks"])
            for bank in rec["bank_ids"] or ():
                waves = rec["waves"] - 1 if bank in early else rec["waves"]
                x(f"{rec['op']} {rec['shape']}", 2, bank,
                  rec["admit_vt"] * us_per_cycle,
                  rec["duration_vt"] * waves * us_per_cycle,
                  {"tile_seq": rec["seq"], "backend": rec["backend"],
                   "cycles": rec["total_cycles"], "waves": rec["waves"],
                   "requests": rec["requests"]})

        for kind, seq, vt, attrs in self._events:
            ev.append({"name": kind.upper(), "ph": "i", "s": "t",
                       "pid": 2, "tid": sched_tid, "cat": "scheduler",
                       "ts": vt * us_per_cycle,
                       "args": {"seq": seq, **attrs}})
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": {"clock_hz": self.clock_hz,
                              "wall_origin_s": t0}}

    def dump(self, path: str, bank_labels=None) -> dict:
        doc = self.export(bank_labels=bank_labels)
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc
