"""Continuous vs flush-barrier serving under arrival workloads.

The twin of the reference's ``benchmarks/streaming_bench.py`` on the
port's engine, with its row names and bands; the real-engine rows run on
``device`` (the CUDA kernels on ``cuda``, their plain versions on
``cpu``), the cycle-domain rows are the same simulation on the host.

Measures the continuous-serving claim: event-clock admission (tiles granted banks the
moment earlier tiles drain) beats batch-synchronous waves (every batch a
global flush barrier) on tail latency and sustained throughput once traffic
arrives continuously instead of as one pre-loaded queue.

The comparison is a deterministic discrete-event simulation in the §V
cycle domain — both disciplines run the *same* arrival trace through the
same :class:`ContinuousScheduler` machinery and the same cost-model service
times (``estimate_colskip_cycles``), so the only difference is the serving
policy:

  * **continuous** — every tile is fed with its own arrival timestamp; the
    event clock admits it when banks drain; its latency is arrival->retire;
  * **flush-barrier** — arrivals are collected into batches (closed on a
    window or a size cap, like a micro-batching front door), each
    batch is fed all-at-once after the previous batch fully retired, and
    every tile's latency runs to its **batch end** — the barrier.

Workloads: Poisson arrivals (exponential gaps, mixed widths) for the
steady-traffic picture, and a bursty trace (a 4-shard giant plus a cohort
of narrow tiles per burst) where the barrier strands half the pool in
every batch tail.  Latencies are reported at the modeled 500 MHz clock;
tiles/s is tiles over makespan at that clock.

An **overload** trace measures the backpressure watermarks: offered
load well past pool capacity, served three ways on the same event
machinery — no admission policy (the queue grows without bound), defer
watermarks, and shed watermarks.  Reported per row: p50/p99 of *served*
tiles, peak admission-queue depth, and the shed/deferred counts — the
acceptance is bounded queue depth and a better served-p99 with
backpressure on vs off.

**Degraded-mode** rows serve the same workload through a healthy
engine, one with a permanently dead bank, and one under a transient-error
storm — the fault layer's verified retry must recover every request
oracle-correct, with the cost visible as virtual throughput, not answers.

Two wall-clock rows ride along: a real engine serving a streaming session
locally, and through the mesh bank pool (on the card the mesh kernel, a
thread-block cluster a row) — the ``--mesh`` analogue inside one process.
Fleet rows close the suite: 1 vs 2 replicas behind a ``FleetRouter`` on
the overload trace, and a rolling restart under live traffic.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only streaming
    PYTHONPATH=src python -m repro_torch.benchmarks.streaming_bench \
        [--device cpu]

On the CPU the real-engine rows keep every row and band but serve fewer
and narrower requests (``QUICK``): there the plain colskip machine, some
0.1 s a small tile, would take minutes at the card's sizes (``FULL``).
"""

from __future__ import annotations

import gc
import time

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.costmodel import BASE_CLOCK_MHZ, estimate_colskip_cycles
from repro_torch.sortserve import EngineConfig, SortRequest, SortServeEngine
from repro_torch.sortserve.batcher import Tile
from repro_torch.sortserve.scheduler import (
    BankPool,
    ContinuousScheduler,
    WatermarkPolicy,
)

ROWS = 8
CYC_TO_S = 1.0 / (BASE_CLOCK_MHZ * 1e6)

# sizes of the real-engine rows: the reference's (FULL, on the card), and
# the CPU's (QUICK: fewer, narrower requests and fewer passes, same rows)
FULL = {"session_lens": (64, 128, 256), "session_reqs": 24,
        "canon_reqs": 96, "canon_max_len": 512, "warm_rounds": 2,
        "passes": 5, "scrapes": 200}
QUICK = {"session_lens": (32, 64), "session_reqs": 8,
         "canon_reqs": 12, "canon_max_len": 64, "warm_rounds": 1,
         "passes": 1, "scrapes": 20}


def _tile(width: int) -> Tile:
    return Tile(op="sort", data=np.zeros((ROWS, width), np.uint32), k=None,
                entries=[], pad_rows=ROWS)


class ModelExec:
    """Deterministic executor: §V cost-model cycles, no real sorting."""

    def __call__(self, tile):
        per_row = int(estimate_colskip_cycles(tile.shape[1]))
        return type("R", (), {"cycles": np.full(tile.shape[0], per_row,
                                                np.int64)})()


def poisson_trace(n: int, seed: int, mean_gap: float,
                  widths=(64, 128, 256, 512)):
    """(arrival_cycle, width) pairs with exponential inter-arrival gaps."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.exponential(mean_gap))
        out.append((t, int(rng.choice(widths))))
    return out

def bursty_trace(n_bursts: int, gap: float, n_narrow: int = 12,
                 wide: int = 1024, narrow: int = 64):
    """Per burst: one 4-shard giant plus a cohort of 1-shard tiles.

    The giant's service time exceeds the burst gap, so a flush barrier
    strands the pool's other banks through every batch tail; continuous
    admission backfills them from the next burst."""
    out = []
    for b in range(n_bursts):
        t = b * gap
        out.append((t, wide))
        out.extend((t, narrow) for _ in range(n_narrow))
    return out


def serve_continuous(trace, pool: BankPool):
    """Feed the trace with real arrival times; latency = arrival -> retire."""
    sched = ContinuousScheduler(pool)
    ex = ModelExec()
    lat = []
    by_id = {}

    def sink(tile, result, exc):
        lat.append(sched.vt - by_id[id(tile)])

    tiles = [(_tile(w), t) for t, w in trace]
    for tile, t in tiles:
        by_id[id(tile)] = t
    for tile, t in tiles:
        sched.feed([tile], ex, sink=sink, at=t)
    sched.pump()
    return np.asarray(lat), sched.telemetry()


def serve_flush_barrier(trace, pool: BankPool, window: float,
                        max_batch: int = 16):
    """Micro-batching with a global barrier, on the same event machinery.

    Batches close ``window`` cycles after their first arrival or at
    ``max_batch`` tiles; batch b is fed all-at-once at
    ``max(close_b, end_{b-1})`` (the engine is synchronous: submit returns
    only when every tile retired) and every tile's latency runs to the
    batch's last retire."""
    sched = ContinuousScheduler(pool)
    ex = ModelExec()
    batches, cur = [], []
    for t, w in trace:
        if cur and (t - cur[0][0] >= window or len(cur) >= max_batch):
            batches.append(cur)
            cur = []
        cur.append((t, w))
    if cur:
        batches.append(cur)
    lat = []
    for batch in batches:
        close = max(batch[0][0] + window, batch[-1][0])
        start = max(close, sched.vt)
        done = []
        sched.feed([_tile(w) for _, w in batch], ex,
                   sink=lambda tile, result, exc: done.append(tile),
                   at=start)
        sched.pump()
        end = sched.vt                     # the flush barrier: batch retire
        lat.extend(end - t for t, _ in batch)
    return np.asarray(lat), sched.telemetry()


def _quantiles_us(lat_cyc: np.ndarray) -> dict:
    to_us = CYC_TO_S * 1e6
    return {q: float(np.percentile(lat_cyc, q)) * to_us
            for q in (50, 95, 99)}


def _tiles_per_s(n_tiles: int, makespan_cyc: float) -> float:
    return n_tiles / (makespan_cyc * CYC_TO_S) if makespan_cyc else 0.0


def _bench_discipline(report, name: str, trace, window: float):
    rows = {}
    for mode in ("continuous", "flush"):
        pool = BankPool(banks=8, bank_width=256, bank_rows=ROWS)
        if mode == "continuous":
            lat, telem = serve_continuous(trace, pool)
        else:
            lat, telem = serve_flush_barrier(trace, pool, window)
        q = _quantiles_us(lat)
        tps = _tiles_per_s(len(trace), telem["continuous"]["makespan_vt"])
        rows[mode] = (q, tps, telem)
        report(
            name=f"streaming/{name}_{mode}",
            us_per_call=q[95],
            derived=(f"p50={q[50]:.0f}us p95={q[95]:.0f}us p99={q[99]:.0f}us "
                     f"tiles_s={tps:.0f} "
                     f"occ={telem['continuous']['occupancy']:.2f} "
                     f"midwave={telem['mid_wave_admissions']}"),
        )
    (qc, tc, _), (qf, tf, _) = rows["continuous"], rows["flush"]
    p95_ratio = qf[95] / qc[95] if qc[95] else float("inf")
    tps_ratio = tc / tf if tf else float("inf")
    ok = qc[95] < qf[95] and tps_ratio >= 1.2
    report(
        name=f"streaming/{name}_speedup",
        us_per_call=qc[95],
        derived=(f"p95_ratio={p95_ratio:.2f}x tiles_s_ratio={tps_ratio:.2f}x "
                 + ("PASS" if ok else "MISS")),
    )
    return ok


def serve_overload(trace, pool: BankPool, policy):
    """Feed an over-capacity trace through a watermarked scheduler.

    Returns (latencies of served tiles, shed count, telemetry)."""
    sched = ContinuousScheduler(pool, policy=policy)
    ex = ModelExec()
    lat, shed = [], [0]
    by_id = {}

    def sink(tile, result, exc):
        if exc is not None:
            shed[0] += 1
        else:
            lat.append(sched.vt - by_id[id(tile)])

    tiles = [(_tile(w), t) for t, w in trace]
    for tile, t in tiles:
        by_id[id(tile)] = t
    for tile, t in tiles:
        sched.feed([tile], ex, sink=sink, at=t, strict=False)
    sched.pump()
    return np.asarray(lat), shed[0], sched.telemetry()


def _bench_overload(report):
    """Backpressure on vs off under sustained over-capacity traffic.

    8 banks x 256-wide tiles: one tile per bank, service ~2008 cycles, so
    capacity is one admission per ~251 cycles; the trace offers one per 150
    (≈1.7x overload, 600 arrivals).  Without a policy the admission queue
    grows without bound and served latency climbs linearly; watermarks
    bound the queue and keep the served tail flat (shed) or bounded by the
    deferral deadline (defer)."""
    modes = {
        "off": None,
        "defer": WatermarkPolicy(high_watermark=32, retry_after_vt=4000.0,
                                 deadline_vt=200_000.0),
        "shed": WatermarkPolicy(high_watermark=32, shed=True,
                                retry_after_vt=4000.0),
    }
    trace = [(i * 150.0, 256) for i in range(600)]
    rows = {}
    for mode, policy in modes.items():
        pool = BankPool(banks=8, bank_width=256, bank_rows=ROWS)
        lat, shed, telem = serve_overload(trace, pool, policy)
        cont = telem["continuous"]
        q = _quantiles_us(lat) if len(lat) else {50: 0.0, 95: 0.0, 99: 0.0}
        rows[mode] = (q, shed, cont)
        report(
            name=f"streaming/overload_{mode}",
            us_per_call=q[99],
            derived=(f"p50={q[50]:.0f}us p99={q[99]:.0f}us "
                     f"served={len(lat)} shed={shed} "
                     f"shed_rate={shed / len(trace):.2f} "
                     f"deferred={cont['deferred']} "
                     f"queued_peak={cont['queued_peak']} "
                     f"crossings={cont['high_watermark_crossings']}"),
        )
    (q_off, _, c_off), (q_shed, n_shed, c_shed) = rows["off"], rows["shed"]
    ok = (q_shed[99] < q_off[99]
          and c_shed["queued_peak"] < c_off["queued_peak"]
          and n_shed > 0)
    report(
        name="streaming/overload_backpressure",
        us_per_call=q_shed[99],
        derived=(f"p99_ratio={q_off[99] / max(q_shed[99], 1e-9):.1f}x "
                 f"queue_peak {c_off['queued_peak']}->"
                 f"{c_shed['queued_peak']} "
                 + ("PASS" if ok else "MISS")),
    )
    return ok


def _bench_real_session(report, mesh: bool, device, size=FULL):
    """Wall-clock sanity row: a real engine serving a streaming session
    (through the mesh bank pool with ``mesh``: on the card, the mesh
    kernel)."""
    label = "mesh" if mesh else "local"
    backends = (("colskip_mesh", "numpy") if mesh
                else ("colskip", "numpy"))
    engine = SortServeEngine(EngineConfig(
        backends=backends, tile_rows=4, banks=8, bank_width=256,
        bank_rows=4, sim_width_cap=512, cache_size=0, mesh=mesh,
        device=device))
    rng = np.random.default_rng(3)
    reqs = [SortRequest("sort", rng.integers(0, 1 << 32, int(rng.choice(
        size["session_lens"])), dtype=np.uint64).astype(np.uint32))
        for _ in range(size["session_reqs"])]
    engine.submit([SortRequest("sort", r.payload.copy()) for r in reqs[:8]])
    session = engine.begin()               # warm pass above, measured below
    t0 = time.perf_counter()
    got = []
    for i in range(0, len(reqs), 4):
        got += session.feed(reqs[i:i + 4])
    got += session.drain()
    dt = time.perf_counter() - t0
    telem = session.telemetry()
    report(
        name=f"streaming/session_{label}",
        us_per_call=dt * 1e6 / len(reqs),
        derived=(f"{len(reqs) / dt:.0f}req/s "
                 f"p95={telem['latency_s']['p95'] * 1e3:.1f}ms "
                 f"admissions={telem['scheduler_delta']['admissions']} "
                 + ("PASS" if len(got) == len(reqs) else "MISS")),
    )


def _bench_tracing_overhead(report, device, size=FULL):
    """Flight-recorder overhead gate.

    The canonical serving workload (``make_workload`` 16–512, mixed ops,
    default engine config — what ``launch.sortserve --smoke`` and
    ``examples/trace_requests.py`` serve) goes through two real engines:
    recorder absent (the default) vs a ring-buffered ``Tracer`` injected.
    Both engines are pre-warmed, then measured passes *alternate* between
    them (best-of-5 sustained req/s each) so scheduler jitter and clock
    drift hit both modes equally.  Tracing off is the untouched baseline
    path; tracing on must stay within 5% of it (``ratio >= 0.95``).
    Absolute hook cost is a few µs per request (preallocated rings, no
    I/O); on this workload colskip execution dominates, which is the
    regime the recorder exists to observe."""
    from repro_torch.launch.sortserve import make_workload
    from repro_torch.obs import Tracer

    n_req, max_len = size["canon_reqs"], size["canon_max_len"]
    engines = {}
    for mode in ("off", "on"):
        engines[mode] = SortServeEngine(EngineConfig(
            cache_size=0, tracer=Tracer() if mode == "on" else None,
            device=device))
        # warm rounds: every launcher builds outside the measured window
        for rnd in range(size["warm_rounds"]):
            engines[mode].submit(make_workload(
                n_req, min_len=16, max_len=max_len, seed=100 + rnd))

    def one_pass(engine):
        """One canonical round through one session, timed."""
        reqs = make_workload(n_req, min_len=16, max_len=max_len, seed=107)
        half = n_req // 2
        session = engine.begin()
        t0 = time.perf_counter()
        got = len(session.feed(reqs[:half])) + len(session.feed(reqs[half:]))
        got += len(session.drain())
        dt = time.perf_counter() - t0
        return len(reqs) / dt if got == len(reqs) else 0.0

    rates = {"off": 0.0, "on": 0.0}
    for mode in ("off", "on"):          # untimed: settle allocator/caches
        one_pass(engines[mode])
    gc.collect()                        # earlier benches' garbage is not
    for _ in range(size["passes"]):     # this bench's signal
        for mode in ("off", "on"):      # interleave so drift cancels
            rates[mode] = max(rates[mode], one_pass(engines[mode]))
    ratio = rates["on"] / rates["off"] if rates["off"] else 0.0
    ok = ratio >= 0.95
    report(
        name="streaming/tracing_overhead",
        us_per_call=1e6 / rates["on"] if rates["on"] else 0.0,
        derived=(f"off={rates['off']:.0f}req/s on={rates['on']:.0f}req/s "
                 f"ratio={ratio:.3f} "
                 + ("PASS" if ok else "MISS")),
    )
    return ok


def _bench_export_overhead(report, device, size=FULL):
    """Metrics-export overhead gate.

    A warm engine that has served the canonical workload holds a fully
    populated registry (per-backend/per-op/per-bank counters, histograms
    with thousands of samples, windows, calibration).  One scrape of the
    OpenMetrics exposition (``dump_metrics(None)`` = snapshot capture +
    text render) is timed against one ``telemetry()`` call — the existing
    in-process observability read that every session already pays.
    Measured passes alternate between the two (best-of-200 each, fewer
    under ``QUICK``) so clock
    drift cancels; the exposition must stay within 5% of the telemetry
    read (``ratio <= 1.05``), i.e. a Prometheus scrape costs no more than
    the dict the dashboards already build.  Both are pure reads off the
    serving path — the gate keeps the exporter from ever growing a sort,
    a deepcopy, or an O(samples) percentile pass."""
    from repro_torch.launch.sortserve import make_workload
    from repro_torch.obs import SLOTarget, Tracer

    engine = SortServeEngine(EngineConfig(
        cache_size=0, tracer=Tracer(),
        slo={"bench": SLOTarget(p99_latency_s=0.05)}, device=device))
    for rnd in range(size["warm_rounds"]):   # warm: populate every row
        session = engine.begin(traffic_class="bench", strict=False)
        session.feed(make_workload(size["canon_reqs"], min_len=16,
                                   max_len=size["canon_max_len"],
                                   seed=100 + rnd), flush=True)
        session.drain()

    calls = {"telemetry": lambda: engine.telemetry(),
             "export": lambda: engine.dump_metrics(None)}
    for fn in calls.values():           # untimed settle pass
        fn()
    gc.collect()
    best = {"telemetry": float("inf"), "export": float("inf")}
    for _ in range(size["scrapes"]):
        for mode, fn in calls.items():  # interleave so drift cancels
            t0 = time.perf_counter()
            fn()
            best[mode] = min(best[mode], time.perf_counter() - t0)
    lines = len(engine.dump_metrics(None).splitlines())
    ratio = best["export"] / best["telemetry"] if best["telemetry"] else 0.0
    ok = ratio <= 1.05
    report(
        name="streaming/export_overhead",
        us_per_call=best["export"] * 1e6,
        derived=(f"telemetry={best['telemetry'] * 1e6:.0f}us "
                 f"export={best['export'] * 1e6:.0f}us "
                 f"lines={lines} ratio={ratio:.3f} "
                 + ("PASS" if ok else "MISS")),
    )
    return ok


def _bench_degraded(report, device):
    """Degraded-mode serving rows.

    The same mixed workload through three real engines — healthy, one
    permanently dead bank, and a transient-error storm (15% of targeted
    executions fail) — with the fault layer's verified retry recovering
    every request.  Faults target the numpy backend so the rows are
    kernel-free; the acceptance claim is that *every* request still serves
    oracle-correct (recovered, never dropped), with the degradation cost
    visible in the wall numbers (re-executions) rather than the answers.
    Reported per row: wall tiles/s, wall p99 over per-request tracer
    latencies, and the recovered/quarantine/shed counts."""
    from repro_torch.launch.sortserve import check_against_oracle, make_workload
    from repro_torch.obs import Tracer
    from repro_torch.sortserve import FaultPlan, RecoveryPolicy

    recovery = RecoveryPolicy(max_retries=8, backoff_base_vt=64.0)
    plans = {
        "healthy": None,
        "dead_bank": FaultPlan(seed=81, dead_banks=(7,),
                               targets=frozenset({"numpy"}),
                               recovery=recovery),
        "transient_storm": FaultPlan(seed=82, transient_rate=0.15,
                                     targets=frozenset({"numpy"}),
                                     recovery=recovery),
    }
    ok = True
    healthy_tps = None
    for label, plan in plans.items():
        tracer = Tracer()
        engine = SortServeEngine(EngineConfig(
            backends=("numpy",), tile_rows=8, banks=8, bank_width=256,
            bank_rows=8, sim_width_cap=512, cache_size=0, tracer=tracer,
            faults=plan, device=device))
        reqs = make_workload(120, min_len=16, max_len=512, seed=5)
        session = engine.begin(strict=False)
        t0 = time.perf_counter()
        got = session.feed(reqs, flush=True) + session.drain()
        dt = time.perf_counter() - t0
        failed = session.take_failures()
        by_id = {r.request_id: r for r in got}
        mismatches = sum(q.request_id in by_id
                         and not check_against_oracle(q, by_id[q.request_id])
                         for q in reqs)
        telem = engine.telemetry()
        cont = telem["scheduler"]["continuous"]
        ft = telem["fault"]
        tps = telem["scheduler"]["tiles"] / dt if dt else 0.0
        lat = sorted(c["latency_s"] for c in tracer.chains
                     if c["latency_s"] is not None)
        p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))] if lat else 0.0
        row_ok = (len(got) == len(reqs) and not failed and mismatches == 0
                  and (plan is None or ft["retries"] > 0))
        ok = ok and row_ok
        if label == "healthy":
            healthy_tps = tps
        report(
            name=f"streaming/degraded_{label}",
            us_per_call=p99 * 1e6,
            derived=(f"tiles_s={tps:.0f} p99={p99 * 1e3:.2f}ms "
                     f"served={len(got)}/{len(reqs)} "
                     f"recovered={ft['retries']} "
                     f"quarantines={ft['quarantines']} "
                     f"shed={cont['shed']} exhausted={ft['exhausted']} "
                     + ("PASS" if row_ok else "MISS")),
        )
    # the summary claim: degradation costs throughput, never answers
    report(
        name="streaming/degraded_recovery",
        us_per_call=0.0,
        derived=(f"healthy_tiles_s={healthy_tps or 0.0:.0f} "
                 + ("PASS" if ok else "MISS")),
    )
    return ok


def _bench_fleet(report, device):
    """Fleet scale-out rows.

    The overload trace (one 256-wide tile per 150 cycles, ~1.7x a
    single 8-bank pool's capacity) served by 1 vs 2 engine replicas behind
    a :class:`FleetRouter`, in the §V cycle domain: ``router.select``
    drives placement per arrival, each replica's own event scheduler
    serves cost-model tiles under the overload rows' shed watermarks, one
    ``pump`` per replica replays the trace.  A single replica sheds the
    over-capacity ~40%; two replicas absorb the whole trace — the
    acceptance gate is >=1.5x served tiles/s with a lower served p99."""
    from repro_torch.sortserve import FleetRouter

    trace = [(i * 150.0, 256) for i in range(600)]

    def replica():
        return SortServeEngine(EngineConfig(
            backends=("numpy",), tile_rows=ROWS, banks=8, bank_width=256,
            bank_rows=ROWS, sim_width_cap=512, cache_size=0,
            admission=WatermarkPolicy(high_watermark=32, shed=True,
                                      retry_after_vt=4000.0),
            device=device))

    rows = {}
    for n_rep in (1, 2):
        router = FleetRouter([replica() for _ in range(n_rep)], seed=7)
        scheds = [rep.engine.scheduler for rep in router.replicas]
        ex = ModelExec()
        lat, shed, arrive = [], [0], {}

        def make_sink(sched):
            def sink(tile, result, exc):
                if exc is not None:
                    shed[0] += 1
                else:
                    lat.append(sched.vt - arrive[id(tile)])
            return sink

        sinks = [make_sink(s) for s in scheds]
        for t, w in trace:
            i = router.select(op="sort", n=w, now=t)
            tile = _tile(w)
            arrive[id(tile)] = t
            scheds[i].feed([tile], ex, sink=sinks[i], at=t, strict=False)
        for s in scheds:
            s.pump()
        makespan = max(s.telemetry()["continuous"]["makespan_vt"]
                       for s in scheds)
        q = _quantiles_us(np.asarray(lat)) if lat \
            else {50: 0.0, 95: 0.0, 99: 0.0}
        tps = _tiles_per_s(len(lat), makespan)
        rows[n_rep] = (q, tps, len(lat), shed[0])
        report(
            name=f"streaming/fleet_{n_rep}replica",
            us_per_call=q[99],
            derived=(f"served={len(lat)}/{len(trace)} shed={shed[0]} "
                     f"p50={q[50]:.0f}us p99={q[99]:.0f}us "
                     f"tiles_s={tps:.0f}"),
        )
    (q1, t1, _, sh1), (q2, t2, _, sh2) = rows[1], rows[2]
    ratio = t2 / t1 if t1 else float("inf")
    ok = ratio >= 1.5 and q2[99] < q1[99]
    report(
        name="streaming/fleet_scaleout",
        us_per_call=q2[99],
        derived=(f"tiles_s_ratio={ratio:.2f}x "
                 f"p99 {q1[99]:.0f}->{q2[99]:.0f}us shed {sh1}->{sh2} "
                 + ("PASS" if ok else "MISS")),
    )
    return ok


def _bench_rolling_restart(report, device):
    """Rolling-restart row: warm-started replica swaps under live traffic.

    Two numpy-only replicas serve the canonical 120-request workload in
    chunks; in the rolling run each slot is restarted in turn midway,
    prewarmed from the fleet's merged warm-state artifact, while the
    sibling absorbs traffic.  Acceptance: the restart run serves every
    request oracle-correct with **zero shed increase** over the steady
    run (both 120/120, no sheds, no failures)."""
    from repro_torch.launch.sortserve import check_against_oracle, make_workload
    from repro_torch.sortserve import FleetRouter

    def replica():
        return SortServeEngine(EngineConfig(
            backends=("numpy",), tile_rows=8, banks=8, bank_width=256,
            bank_rows=8, sim_width_cap=512, cache_size=0, device=device))

    rows, ok = {}, True
    for mode in ("steady", "rolling"):
        router = FleetRouter([replica(), replica()],
                             engine_factory=replica, seed=0)
        reqs = make_workload(120, min_len=16, max_len=512, seed=5)
        served = mismatches = 0
        t0 = time.perf_counter()
        for ci in range(0, len(reqs), 20):
            if mode == "rolling" and ci in (40, 80):
                router.restart(0 if ci == 40 else 1,
                               warm_state=router.save_warm_state())
            chunk = reqs[ci:ci + 20]
            resps, _fails = router.serve(chunk)
            for q_req, r in zip(chunk, resps):
                if r is not None:
                    served += 1
                    mismatches += not check_against_oracle(q_req, r)
        dt = time.perf_counter() - t0
        telem = router.telemetry()
        rows[mode] = telem
        row_ok = (served == len(reqs) and mismatches == 0
                  and telem["shed"] == 0 and telem["failed"] == 0
                  and (mode == "steady" or telem["restarts"] == 2))
        ok = ok and row_ok
        report(
            name=f"streaming/fleet_{mode}",
            us_per_call=dt * 1e6 / len(reqs),
            derived=(f"{len(reqs) / dt:.0f}req/s "
                     f"served={served}/{len(reqs)} shed={telem['shed']} "
                     f"restarts={telem['restarts']} "
                     f"redirects={telem['redirects']} "
                     + ("PASS" if row_ok else "MISS")),
        )
    shed_delta = rows["rolling"]["shed"] - rows["steady"]["shed"]
    ok = ok and shed_delta == 0
    report(
        name="streaming/fleet_rolling_restart",
        us_per_call=0.0,
        derived=(f"shed_delta={shed_delta} "
                 f"restarts={rows['rolling']['restarts']} "
                 + ("PASS" if ok else "MISS")),
    )
    return ok


def run(report, device="cuda"):
    dev = resolve_device(device)
    size = FULL if dev.type == "cuda" else QUICK
    # Poisson steady traffic: ~70% offered load on the 8-bank pool
    trace_p = poisson_trace(400, seed=11, mean_gap=2400.0)
    _bench_discipline(report, "poisson", trace_p, window=4000.0)
    # Bursty: a 4-shard giant + 12 narrow tiles per burst, gap below the
    # giant's service time — the acceptance workload
    trace_b = bursty_trace(40, gap=40_000.0)
    _bench_discipline(report, "bursty", trace_b, window=8000.0)
    # Sustained over-capacity traffic: backpressure watermarks vs unbounded
    # queueing
    _bench_overload(report)
    _bench_real_session(report, False, dev, size)
    # flight-recorder overhead: tracer on vs off through a real engine (on
    # must stay within 5% of off)
    _bench_tracing_overhead(report, dev, size)
    # metrics-export overhead: one OpenMetrics scrape vs one telemetry()
    # read on a warm engine (ratio <= 1.05)
    _bench_export_overhead(report, dev, size)
    # degraded-mode serving: healthy vs dead-bank vs transient storm, every
    # request recovered oracle-correct
    _bench_degraded(report, dev)
    # fleet scale-out: the overload trace through 1 vs 2 replicas behind
    # the FleetRouter (>= 1.5x tiles/s)
    _bench_fleet(report, dev)
    # rolling restart: warm-started replica swaps under live traffic with
    # zero shed increase
    _bench_rolling_restart(report, dev)
    # the same session through the mesh bank pool (the mesh kernel on the
    # card)
    _bench_real_session(report, True, dev, size)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the real engines run: cuda or cpu")
    args = ap.parse_args()
    print("name,us_per_call,derived")

    def report(name, us_per_call, derived):
        print(f"{name},{us_per_call:.1f},{derived}", flush=True)

    run(report, device=args.device)


if __name__ == "__main__":
    main()
