"""Flight-recorder span tracing for the serving stack, and the engine's
stage spans.

One :class:`Tracer` records one **span chain per request** —

    feed -> ingest -> bucket -> admit -> execute -> scatter -> retire

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

:class:`Stages` times the engine's host work a tile or a call at a time:
``sortserve.feed`` / ``bucket`` / ``emit`` / ``schedule`` / ``execute`` /
``scatter``, ``<backend>.h2d`` / ``launch`` / ``d2h`` and the front door's
``frontdoor.collect``; on a model (``model.stages``) the generation
path's ``generate.*`` and the MoE layer's ``moe.*``, beside the model's
:class:`Counters`.  Each stage adds to an always-on table of counts,
seconds and self seconds (``telemetry()["stages"]``); while
``torch.profiler`` records on the calling thread it also opens a profiler
range of the same name, so a device trace names the stage the host was
in; with a tracer it also writes the span into the tracer's stage ring.

Design constraints, in order:

  * **Low overhead** — every request hook is a handful of dict writes
    under the engine lock, with no formatting, no I/O and no clock reads
    of its own (every request and tile stamp is passed in from the
    engine's clock, so chains are deterministic under a fake clock).  The
    stage spans read a clock of their own, ``time.perf_counter`` (the
    engine's default clock), twice a span, and ask the profiler whether it
    records; ``scripts/stage_cost.py`` measures what a span costs, with
    and without a profiler running.
  * **Bounded memory** — finished request chains, retired tile records,
    scheduler events and stage spans land in rings of ``capacity``; the
    recorder forgets the old past, never grows without bound.
    Flight-recorder semantics also mean the trace is *exempt from submit
    rollback*: a failed batch rolls back telemetry counters, but what the
    recorder saw, it keeps (like the executor cache keeps its compiles);
    the stage table keeps the time that was spent, too.
  * **Off by default** — the engine only calls the request hooks when a
    tracer was injected via ``EngineConfig(tracer=...)``; without one,
    the stage table is the only recording on the serving path.

:meth:`Tracer.export` renders the recording as Chrome trace-event JSON
(``chrome://tracing`` / https://ui.perfetto.dev): process 1 is the wall
domain (one track per request), process 2 is the virtual-time domain at the
modeled clock (one track per bank, plus a scheduler-event track).  When the
engine runs on its default clock the wall stamps are written in Unix-epoch
microseconds, the clock of ``torch.profiler``'s trace, so both load on one
time axis, and process 3 holds the engine's stage spans (one track per
thread).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import deque
from numbers import Number

from repro_torch.core.costmodel import BASE_CLOCK_MHZ

__all__ = ["NO_STAGES", "Stages", "Tracer"]

# statuses a finalized request chain can carry
SERVED, CACHE_HIT, SHED, FAILED, ABORTED = (
    "served", "cache_hit", "shed", "failed", "aborted")

# hot-path templates: one C-level ``dict.copy`` beats rebuilding the
# full literal on every request/tile (these hooks run inside the engine
# lock on the serving fast path)
_CHAIN_TEMPLATE = {
    "rid": None, "op": None, "n": None, "traffic_class": None,
    "t_feed": None, "t_ingest": None, "t_bucket": None, "t_done": None,
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

    ``capacity`` bounds every ring (finished request chains, retired tile
    records, scheduler events, stage spans); ``clock_hz`` maps virtual-time
    cycles onto export microseconds (default: the modeled 500 MHz part).

    ``anchor`` is ``(time.perf_counter_ns(), time.time_ns())`` read back
    to back at construction; an engine on its default clock sets
    ``perf_clock``, and :meth:`export` then writes wall stamps in
    Unix-epoch microseconds through it.
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
        # stage spans, a ring of columns (name, t0, t1, span, parent,
        # tile seq, thread) written in place: recording a span allocates
        # nothing the garbage collector tracks, and the ring adds seven
        # objects to the heap, not one a slot
        self._spans = [[None] * capacity for _ in range(7)]
        self._spans_written = 0
        self._active: dict[int, dict] = {}            # rid -> open chain
        self._open_tiles: dict[int, dict] = {}        # seq -> open record
        self._seq = itertools.count(1)
        # Chain/record dicts are preallocated here and recycled through
        # freelists when the rings wrap, so recording allocates (almost)
        # nothing on the serving path: the pool promotes to the old GC
        # generation once and young-gen collections never see recorder
        # garbage again.  Consequence (flight-recorder semantics): a
        # reference held to an evicted chain/record sees it overwritten
        # with newer data once the ring wraps.
        self._chain_free = [dict(_CHAIN_TEMPLATE) for _ in range(capacity)]
        self._record_free = [dict(_RECORD_TEMPLATE) for _ in range(capacity)]
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.perf_clock = False     # wall stamps are time.perf_counter's

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
                     traffic_class: str | None, wall: float,
                     ingest: float | None = None) -> None:
        """A request entered a session (post-validation, pre-bucket).
        ``wall`` is its feed stamp (the front door's submit stamp);
        ``ingest`` is when the front door's collector took it off its
        queue (``wall`` itself for a request fed directly)."""
        chain = self._new_chain()
        chain["rid"] = rid
        chain["op"] = op
        chain["n"] = n
        chain["traffic_class"] = traffic_class
        chain["t_feed"] = wall
        chain["t_ingest"] = wall if ingest is None else ingest
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
        chain["t_feed"] = chain["t_ingest"] = chain["t_bucket"] = \
            chain["t_done"] = wall
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

    # --------------------------------------------------------------- stages
    def stage_span(self, name: str, t0: float, t1: float, span: int,
                   parent: int | None, seq: int | None, tid: int) -> None:
        """One closed :class:`Stages` span: its id, the id of the span
        that encloses it (None at a root), the tile's ``trace_seq`` (None
        outside a tile) and the recording thread's track."""
        k = self._spans_written % self.capacity
        self._spans_written += 1
        names, t0s, t1s, spans, parents, seqs, tids = self._spans
        names[k] = name
        t0s[k] = t0
        t1s[k] = t1
        spans[k] = span
        parents[k] = parent
        seqs[k] = seq
        tids[k] = tid

    @property
    def stage_spans(self) -> list[tuple]:
        """The stage ring, oldest first, as ``(name, t0, t1, span,
        parent, seq, tid)`` tuples (materialized on access)."""
        n = min(self._spans_written, self.capacity)
        start = self._spans_written - n
        rows = list(zip(*self._spans))
        return [rows[(start + i) % self.capacity] for i in range(n)]

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
        spans (``request`` ⊃ ``frontdoor`` / ``bucket`` / ``admit`` /
        ``execute`` / ``scatter``) with the virtual-time story attached as
        span args; ``frontdoor`` (submit to the collector's ingest) only
        for a request that waited in the front door's queue.
        pid 2: the virtual-time domain mapped at ``clock_hz`` — one thread
        per bank (labelled via ``bank_labels``, device-aware on a mesh
        pool) carrying tile occupancy spans, plus one scheduler-event
        thread of ARRIVE/ADMIT/DEFER/SHED/EARLY/RETIRE instants.
        pid 3: the engine's stage spans, one thread per recording thread,
        only with ``perf_clock`` set.

        With ``perf_clock`` set (the engine's default clock) every wall
        ``ts`` is in Unix-epoch microseconds (``otherData["clock"]`` is
        ``"unix_us"``), the clock of ``torch.profiler``'s chrome trace;
        otherwise the request spans count from the first feed
        (``"engine"``, ``wall_origin_s``), and the stage spans, which
        always read ``time.perf_counter``, share an axis with nothing in
        the document and are left out.
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
        perf_ns, unix_ns = self.anchor

        def unix_us(wall: float) -> float:
            return (wall - perf_ns / 1e9) * 1e6 + unix_ns / 1e3

        if self.perf_clock:
            t0 = None
            us = unix_us
        else:
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
            t_in = c["t_ingest"]
            if t_in is None:
                t_in = c["t_feed"]
            elif t_in > c["t_feed"]:
                x("frontdoor", 1, c["rid"], us(c["t_feed"]),
                  us(t_in) - us(c["t_feed"]), {})
            x("bucket", 1, c["rid"], us(t_in), us(c["t_bucket"]) - us(t_in),
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

        spans = list(self.stage_spans) if self.perf_clock else []
        if spans:
            ev.append({"name": "process_name", "ph": "M", "pid": 3,
                       "args": {"name": "engine stages (wall clock)"}})
        for tid in sorted({sp[6] for sp in spans}):
            ev.append({"name": "thread_name", "ph": "M", "pid": 3,
                       "tid": tid, "args": {"name": f"thread {tid}"}})
        for name, s0, s1, span, parent, seq, tid in spans:
            ev.append({"name": name, "ph": "X", "pid": 3, "tid": tid,
                       "ts": unix_us(s0), "dur": max(s1 - s0, 0.0) * 1e6,
                       "cat": "stage",
                       "args": {"span": span, "parent": parent,
                                "tile_seq": seq}})
        other = {"clock_hz": self.clock_hz,
                 "clock": "unix_us" if self.perf_clock else "engine",
                 "anchor": {"perf_counter_ns": perf_ns, "time_ns": unix_ns}}
        if t0 is not None:
            other["wall_origin_s"] = t0
        return {"traceEvents": ev, "displayTimeUnit": "ms",
                "otherData": other}

    def dump(self, path: str, bank_labels=None) -> dict:
        doc = self.export(bank_labels=bank_labels)
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc


class _Span:
    """One :class:`Stages` span: a context manager, and its frame on the
    thread's stack while it is open."""

    __slots__ = ("stages", "name", "tile", "t0", "child", "rng", "span",
                 "parent", "seq")

    def __init__(self, stages: "Stages", name: str, tile) -> None:
        self.stages = stages
        self.name = name
        self.tile = tile
        self.child = 0.0

    def __enter__(self) -> "_Span":
        st = self.stages
        local = st._local
        try:
            stack = local.stack
        except AttributeError:
            stack = local.stack = []
            local.tid = next(st._tids)
        if st.tracer is not None:
            self.span = next(st._ids)
            up = stack[-1] if stack else None
            self.parent = up.span if up is not None else None
            self.seq = (self.tile.obs.get("trace_seq")
                        if self.tile is not None
                        else up.seq if up is not None else None)
        stack.append(self)
        # the range opens and closes next to the clock's reads, so the
        # profiler's stamps and the span's lie as close as two calls can
        if st._recording():
            self.rng = st._range(self.name)
            self.rng.__enter__()
        else:
            self.rng = None
        self.t0 = st.clock()
        return self

    def __exit__(self, *exc) -> None:
        st = self.stages
        t1 = st.clock()
        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        stack = st._local.stack
        stack.pop()
        dt = t1 - self.t0
        row = st.table.get(self.name)
        if row is None:
            row = st.table[self.name] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += dt
        row[2] += self.child
        if stack:
            stack[-1].child += dt
        if st.tracer is not None:
            st.tracer.stage_span(self.name, self.t0, t1, self.span,
                                 self.parent, self.seq, st._local.tid)


class Stages:
    """The engine's stage spans: one span primitive for every layer
    boundary of the serving path, a tile or a call at a time.

    A span (``with stages.stage(name, tile):``) does three things:

      * adds to :attr:`table`, always: ``name -> [count, seconds, child
        seconds]``; :meth:`section` renders it as ``{"n", "s", "self_s"}``,
        self time being the span's time less the spans it encloses on the
        same thread.  The table is the engine's ``telemetry()["stages"]``:
        it keeps the time that was spent, so a failed ``submit`` does not
        roll it back;
      * opens a ``torch.profiler`` range of the same name, only while a
        profiler records on the calling thread
        (``torch.autograd._profiler_enabled()``), so a device trace puts the
        host's time between kernels down to the stage it was in;
      * with a ``tracer``, writes the span into its stage ring
        (:meth:`Tracer.stage_span`) with its enclosing span and its tile's
        ``trace_seq`` (inherited from the enclosing span when no tile is
        given).

    :attr:`clock` is ``time.perf_counter``, the engine's default clock, and
    not an injected engine clock: the stage reads leave a fake clock's
    count of reads, and so everything it stamps, as it was.  The clock is
    read inside the profiler range, so a span's stamps lie within its
    range's.  Each thread keeps its own stack of open spans.  Spans of one
    engine are written under its lock, but for the front door's
    ``frontdoor.collect``, which only its collector thread writes.
    """

    def __init__(self, tracer: Tracer | None = None):
        import torch
        self.clock = time.perf_counter
        self.tracer = tracer
        self.table: dict[str, list] = {}
        self._local = threading.local()
        self._recording = torch.autograd._profiler_enabled
        self._range = getattr(torch._C._profiler, "_RecordFunctionFast",
                              torch.profiler.record_function)
        self._ids = itertools.count(1)
        self._tids = itertools.count(1)

    def __getstate__(self) -> dict:
        """What a copy keeps (a model is copied or pickled with its
        stages): the table, the tracer and the clock; no open span."""
        return {"table": self.table, "tracer": self.tracer,
                "clock": self.clock}

    def __setstate__(self, state: dict) -> None:
        self.__init__(state["tracer"])
        self.table, self.clock = state["table"], state["clock"]

    def stage(self, name: str, tile=None) -> _Span:
        """A span over the ``with`` block; ``tile`` tags tracer spans."""
        return _Span(self, name, tile)

    def section(self) -> dict:
        """``{name: {"n": count, "s": seconds, "self_s": seconds less the
        enclosed spans}}``, a copy."""
        return {name: {"n": n, "s": s, "self_s": s - child}
                for name, (n, s, child) in list(self.table.items())}


class Counters:
    """Named counts that a hot path adds to without a host
    synchronisation: a Python number adds on the host, a tensor on its
    own device (one in-place add; the first is kept as a copy).  Each
    name keeps one kind.  :meth:`section` reads them all: the only
    synchronisation, at a snapshot."""

    def __init__(self):
        self.table: dict = {}

    def add(self, name: str, n) -> None:
        cur = self.table.get(name)
        if isinstance(n, Number):
            self.table[name] = n if cur is None else cur + n
        elif cur is None:
            self.table[name] = n.detach().clone()
        else:
            cur.add_(n)

    def section(self) -> dict:
        """``{name: count}``, plain numbers."""
        return {name: (v if isinstance(v, Number) else v.item())
                for name, v in list(self.table.items())}


class _NoStages:
    """Records nothing: the spans of a backend no engine has adopted."""

    _null = contextlib.nullcontext()

    def stage(self, name: str, tile=None):
        return self._null


NO_STAGES = _NoStages()
