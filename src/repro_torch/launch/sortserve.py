"""Sort-serving driver — mixed request workload through the bank-pool engine.

    PYTHONPATH=src python -m repro_torch.launch.sortserve --smoke
    PYTHONPATH=src python -m repro_torch.launch.sortserve --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.sortserve --smoke --mesh --fuse 2
    PYTHONPATH=src python -m repro_torch.launch.sortserve --smoke \
        --replicas 2 --rolling-restart --warm-state warm.json

The torch port of ``repro.launch.sortserve``.  Generates a seeded stream of
sort / argsort / topk / kmin requests over uint32 / int32 / float32
payloads with log-uniform lengths, serves it through the port's engine on
``--device`` (default ``cuda``: the CUDA kernels; ``cpu``: their plain
torch versions), checks every result bit-identical against the numpy
oracle, and prints the aggregate telemetry (optionally to ``--json``).
``--mesh`` serves colskip tiles through the mesh bank pool (on the card
the mesh kernel: a thread-block cluster a row, a CTA a bank); ``--replicas
N`` through a fleet of N engine replicas behind a ``FleetRouter``, with
``--warm-state`` and ``--rolling-restart``.  The hardware-profile and
compile-cache flags of the reference (XLA flags and jax's persistent
cache) have no counterpart yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

from repro_torch.sortserve import (
    EngineConfig,
    SortRequest,
    SortServeEngine,
    encode_payload,
    solve_numpy,
)
from repro_torch.sortserve.request import decode_values


def make_workload(n_requests: int, min_len: int, max_len: int,
                  seed: int, ops=("sort", "argsort", "topk", "kmin")):
    """Seeded mixed-op / mixed-dtype / mixed-length request stream."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_requests):
        op = ops[int(rng.integers(len(ops)))]
        n = int(np.exp(rng.uniform(np.log(min_len), np.log(max_len))))
        n = max(min_len, min(max_len, n))
        dtype = ("uint32", "int32", "float32")[int(rng.integers(3))]
        if dtype == "uint32":
            payload = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
        elif dtype == "int32":
            payload = rng.integers(-(1 << 31), 1 << 31, size=n,
                                   dtype=np.int64).astype(np.int32)
        else:
            payload = (rng.normal(size=n) * 1e3).astype(np.float32)
        k = int(rng.integers(1, min(64, n) + 1)) if op in ("topk", "kmin") else None
        reqs.append(SortRequest(op=op, payload=payload, k=k))
    return reqs


def check_against_oracle(req: SortRequest, resp) -> bool:
    """Bit-identical comparison of one response against the numpy oracle."""
    vals_u, idxs = solve_numpy(req.op, encode_payload(req.payload), req.k)
    out = req.out_len
    if resp.indices is not None and not np.array_equal(resp.indices, idxs[:out]):
        return False
    if resp.values is not None:
        expect = decode_values(vals_u[:out], req.payload.dtype)
        if not np.array_equal(resp.values, expect):
            return False
        if resp.values.dtype != req.payload.dtype:
            return False
    return True


def _serve_fleet(args, router, reqs) -> int:
    """Serve the workload through a :class:`FleetRouter` fleet.

    With ``--rolling-restart`` the workload goes through in chunks and
    each replica slot is restarted in turn at a chunk boundary, prewarmed
    from the fleet's merged warm-state artifact, while the siblings keep
    serving — the smoke gate is every request served oracle-correct with
    zero fleet-level sheds."""
    n_chunks = max(6, args.replicas + 2) if args.rolling_restart else 1
    csize = (len(reqs) + n_chunks - 1) // n_chunks
    restart_before = ({1 + j: j for j in range(args.replicas)}
                      if args.rolling_restart else {})
    t0 = time.time()
    resps, fails = [], []
    for ci in range(n_chunks):
        slot = restart_before.get(ci)
        if slot is not None:
            router.restart(slot, warm_state=router.save_warm_state())
        got, bad = router.serve(reqs[ci * csize:(ci + 1) * csize])
        resps += got
        fails += bad
    dt = time.time() - t0

    n_served = sum(r is not None for r in resps)
    mismatches = sum(r is not None and not check_against_oracle(q, r)
                     for q, r in zip(reqs, resps))
    fleet = router.telemetry()
    backends_used = sorted({b for rep in router.replicas
                            for b in rep.engine.telemetry()["per_backend"]})
    print(f"device: {args.device}")
    print(f"served {n_served} requests in {dt:.2f}s "
          f"({n_served / dt:.1f} req/s incl kernel builds) "
          f"across {fleet['replicas']} replicas"
          + (f"  [{len(fails)} failed fleet-wide]" if fails else ""))
    print(f"ops: {','.join(sorted({q.op for q in reqs}))}  "
          f"backends: {','.join(backends_used)}")
    print(f"oracle mismatches: {mismatches}")
    print(f"fleet: shed={fleet['shed']} failovers={fleet['failovers']} "
          f"redirects={fleet['redirects']} restarts={fleet['restarts']} "
          f"quarantines={fleet['health']['quarantines']}")
    for name, row in fleet["per_replica"].items():
        print(f"  {name}: {row['state']} routed={row['routed']} "
              f"served={row['served']} shed={row['shed']} "
              f"queue_depth={row['queue_depth']}")
    if args.warm_state:
        router.save_warm_state(args.warm_state)
        print(f"warm state -> {args.warm_state}")
    if args.snapshot_out:
        router.dump_snapshot(args.snapshot_out)
        print(f"snapshot -> {args.snapshot_out}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(fleet, f, indent=2, sort_keys=True)
        print(f"telemetry -> {args.json}")

    if args.smoke:
        assert mismatches == 0, f"{mismatches} responses differ from oracle"
        assert n_served == len(reqs), \
            f"served {n_served}/{len(reqs)} (fleet failures: {fails[:3]})"
        assert fleet["shed"] == 0, f"{fleet['shed']} fleet-level sheds"
        if args.rolling_restart:
            assert fleet["restarts"] == args.replicas, \
                f"{fleet['restarts']} restarts != {args.replicas} replicas"
            print("ROLLING RESTART SMOKE OK")
        print("FLEET SMOKE OK")
        print("SMOKE OK")
    return 0 if mismatches == 0 and n_served == len(reqs) else 1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="200-request mixed workload + oracle verification")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--min_len", type=int, default=64)
    ap.add_argument("--max_len", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backends", default="colskip,radix_topk,jaxsort,numpy")
    ap.add_argument("--device", default="cuda",
                    help="where the backends run: cuda (the CUDA kernels) "
                         "or cpu (their plain torch versions)")
    ap.add_argument("--mesh", action="store_true",
                    help="serve through the mesh-sharded bank pool "
                         "(repro_torch.dist.bankmesh): colskip tiles via the "
                         "colskip_mesh backend, whose banks are the CTAs of "
                         "a thread-block cluster on the card")
    ap.add_argument("--mesh_hosts", type=int, default=1,
                    help="with --mesh: fold the banks into a hierarchical "
                         "hosts x banks 2-axis mesh")
    ap.add_argument("--fuse", type=int, default=1,
                    help="bit planes fused per manager OR round on the mesh "
                         "path (1-8; the card's kernel is built for 1, 2 "
                         "and 4); results are fuse-invariant, only "
                         "collectives.rounds changes")
    ap.add_argument("--tile_rows", type=int, default=8)
    ap.add_argument("--banks", type=int, default=8)
    ap.add_argument("--bank_width", type=int, default=1024)
    ap.add_argument("--sim_width_cap", type=int, default=2048)
    ap.add_argument("--dense", action="store_true",
                    help="dense §III machine (its own CUDA kernel) instead "
                         "of the lane-packed hot path (equivalence baseline)")
    ap.add_argument("--static_policy", action="store_true",
                    help="disable measured-EMA routing; static width cap only")
    ap.add_argument("--high_watermark", type=int, default=0,
                    help="admission-queue depth watermark for overload "
                         "backpressure (0 = accept everything); arrivals "
                         "beyond it defer, or shed with --shed_overload")
    ap.add_argument("--low_watermark", type=int, default=None,
                    help="hysteresis low mark (default: high_watermark/2)")
    ap.add_argument("--shed_overload", action="store_true",
                    help="shed (deterministically reject) arrivals over the "
                         "watermark instead of deferring them")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="arm seeded fault injection: last bank dead, one "
                         "stuck-at lane, one slow bank, --fault_rate "
                         "transient errors; every response must still match "
                         "the oracle via verified retry")
    ap.add_argument("--fault_rate", type=float, default=0.05,
                    help="per-execution transient fault probability under "
                         "--chaos (default 0.05)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a FleetRouter over N independent "
                         "engine replicas (telemetry-driven placement, "
                         "RetryAfter-aware failover); 1 = single engine")
    ap.add_argument("--warm-state", default="", dest="warm_state",
                    help="warm-state artifact path: loaded (if it exists) "
                         "to prewarm every replica before serving, and "
                         "written back (merged across replicas) after")
    ap.add_argument("--rolling-restart", action="store_true",
                    dest="rolling_restart",
                    help="with --replicas >= 2: restart each replica slot "
                         "in turn midway through the workload, prewarmed "
                         "from the fleet's merged warm state, while the "
                         "siblings keep serving")
    ap.add_argument("--json", default="", help="write telemetry JSON here")
    ap.add_argument("--trace", default="",
                    help="enable the flight recorder and write the Chrome "
                         "trace-event JSON here (view at ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default="", dest="metrics_out",
                    help="write the OpenMetrics/Prometheus text exposition "
                         "of the final telemetry here")
    ap.add_argument("--snapshot-out", default="", dest="snapshot_out",
                    help="write the mergeable telemetry snapshot JSON here")
    args = ap.parse_args(argv)

    backends = tuple(s for s in args.backends.split(",") if s)
    if args.mesh_hosts > 1 and not args.mesh:
        ap.error("--mesh_hosts needs --mesh (the hosts axis shards the "
                 "mesh bank pool)")
    if args.fuse > 1 and not args.mesh:
        ap.error("--fuse needs --mesh (plane fusion batches the mesh "
                 "manager's OR rounds; the local engine has no collectives)")
    if args.mesh:
        # the mesh-sharded simulator replaces the local one; §V.C cycle
        # invariance keeps every telemetry assertion identical
        backends = tuple("colskip_mesh" if b == "colskip" else b
                         for b in backends)
    if args.shed_overload and not args.high_watermark:
        ap.error("--shed_overload needs --high_watermark N")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.rolling_restart and args.replicas < 2:
        ap.error("--rolling-restart needs --replicas >= 2 (a sibling must "
                 "absorb traffic while a slot restarts)")
    if args.replicas > 1 and (args.mesh or args.trace or args.metrics_out
                              or args.chaos is not None):
        ap.error("--replicas > 1 drives independent local engines; use "
                 "--mesh/--trace/--metrics-out/--chaos one engine at a time")

    def make_admission():
        if not args.high_watermark:
            return None
        from repro_torch.sortserve import WatermarkPolicy
        # admission policies carry hysteresis state: one fresh instance
        # per engine, never shared across replicas
        return WatermarkPolicy(high_watermark=args.high_watermark,
                               low_watermark=args.low_watermark,
                               shed=args.shed_overload)

    admission = make_admission()
    tracer = None
    if args.trace:
        from repro_torch.obs import Tracer
        tracer = Tracer()
    faults = None
    if args.chaos is not None:
        from repro_torch.sortserve import FaultPlan
        # standard chaos plan: one permanently dead bank (the last), one
        # stuck-at-1 lane, one slow bank, seeded transient errors
        faults = FaultPlan(
            seed=args.chaos,
            transient_rate=args.fault_rate,
            dead_banks=(args.banks - 1,),
            stuck_lanes=((0, 7, 1),),
            slow_banks=((1 % args.banks, 4.0),),
        )
    cfg = EngineConfig(
        tracer=tracer,
        backends=backends,
        tile_rows=args.tile_rows,
        banks=args.banks,
        bank_width=args.bank_width,
        bank_rows=max(args.tile_rows, 8),
        sim_width_cap=args.sim_width_cap,
        mesh=args.mesh,
        mesh_hosts=args.mesh_hosts,
        fuse=args.fuse,
        packed=not args.dense,
        adaptive_policy=not args.static_policy,
        admission=admission,
        faults=faults,
        device=args.device,
    )
    if args.replicas > 1:
        from repro_torch.sortserve import FleetRouter

        def fresh_engine():
            return SortServeEngine(
                dataclasses.replace(cfg, admission=make_admission()))

        router = FleetRouter([fresh_engine() for _ in range(args.replicas)],
                             engine_factory=fresh_engine, seed=args.seed)
        if args.warm_state and os.path.exists(args.warm_state):
            stats = router.load_warm_state(args.warm_state)
            print(f"warm state <- {args.warm_state} "
                  f"({stats['signatures']} signatures, "
                  f"{stats['priors']} priors, {stats['prewarmed']} prewarmed)")
        reqs = make_workload(args.requests, args.min_len, args.max_len,
                             args.seed)
        return _serve_fleet(args, router, reqs)

    engine = SortServeEngine(cfg)
    if args.warm_state and os.path.exists(args.warm_state):
        from repro_torch.sortserve import load_warm_state
        stats = engine.apply_warm_state(load_warm_state(args.warm_state))
        print(f"warm state <- {args.warm_state} "
              f"({stats['signatures']} signatures, "
              f"{stats['priors']} priors, {stats['prewarmed']} prewarmed)")
    reqs = make_workload(args.requests, args.min_len, args.max_len, args.seed)

    if args.mesh:
        from repro_torch.sortserve.backends import ShardedColskipBackend
        ShardedColskipBackend.reset_rounds()
    t0 = time.time()
    shed = []
    if args.shed_overload:
        # shedding rejects requests by design: serve through a strict=False
        # session so sheds surface as accounted failures, not a raise
        session = engine.begin(strict=False)
        got = session.feed(reqs, flush=True) + session.drain()
        shed = session.take_failures()
        by_id = {r.request_id: r for r in got}
        resps = [by_id.get(q.request_id) for q in reqs]
    else:
        resps = engine.submit(reqs)
    dt = time.time() - t0

    n_served = sum(r is not None for r in resps)
    mismatches = sum(r is not None and not check_against_oracle(q, r)
                     for q, r in zip(reqs, resps))
    telem = engine.telemetry()
    backends_used = sorted(telem["per_backend"])
    ops_served = sorted({q.op for q in reqs})

    print(f"device: {args.device}")
    print(f"served {n_served} requests in {dt:.2f}s "
          f"({n_served / dt:.1f} req/s incl kernel builds)"
          + (f"  [{len(shed)} shed]" if shed else ""))
    print(f"ops: {','.join(ops_served)}  backends: {','.join(backends_used)}")
    print(f"oracle mismatches: {mismatches}")
    print(f"aggregate column reads: {telem['column_reads']}  "
          f"exact cycles: {telem['cycles_exact']}  "
          f"estimated cycles: {telem['cycles_estimated']:.0f}")
    print(f"tiles: {telem['batcher']['tiles']}  "
          f"bucket hit-rate: {telem['batcher']['bucket_hit_rate']:.2f}  "
          f"pad col frac: {telem['batcher']['pad_col_frac']:.2f}")
    print("tiles per backend: " + "  ".join(
        f"{name}={pb['tiles']}" for name, pb in sorted(
            telem["per_backend"].items())))
    print(f"executor cache: {telem['executor_cache']['hits']} hits / "
          f"{telem['executor_cache']['misses']} builds "
          f"(hit-rate {telem['executor_cache']['hit_rate']:.2f})")
    coll = telem.get("collectives", {})
    if args.mesh and coll.get("rounds"):
        print(f"collectives: {coll['rounds']} rounds / {coll['planes']} "
              f"planes (round CR {coll['round_cr']:.2f}x, fuse={args.fuse})  "
              f"prefetch {coll['prefetch_hits']}/{coll['prefetch_staged']}")
        if ShardedColskipBackend.static_rounds:
            print(f"mesh kernel: {ShardedColskipBackend.kernel_rounds} "
                  "exchange rounds on the tiles' slowest rows, of a static "
                  f"account of {ShardedColskipBackend.static_rounds}")
    print(f"scheduler drains: {telem['scheduler']['drains']}  "
          f"oversized waves: {telem['scheduler']['oversized_waves']}  "
          f"mid-wave admissions: {telem['scheduler']['mid_wave_admissions']}")
    cont = telem["scheduler"].get("continuous")
    if cont:
        print(f"event clock: {cont['events']} events  "
              f"{cont['admissions']} admissions  "
              f"queue wait {cont['queue_wait_vt']:.0f} cyc  "
              f"occupancy {cont['occupancy']:.2f}  "
              f"makespan {cont['makespan_vt']:.0f} cyc")
        if admission is not None:
            print(f"backpressure: {cont['deferred']} deferred  "
                  f"{cont['shed']} shed  "
                  f"{cont['high_watermark_crossings']} watermark crossings  "
                  f"queued peak {cont['queued_peak']}")
    if faults is not None:
        ft = telem["fault"]
        print(f"chaos: {ft['failures']} faulted executions  "
              f"{ft['retries']} retries  {ft['fallbacks']} fallbacks  "
              f"{ft['guard_failures']} guard catches  "
              f"{ft['quarantines']} quarantines "
              f"({ft['quarantined_now']} still out)  "
              f"{ft['exhausted']} exhausted")
    if args.trace:
        doc = engine.dump_trace(args.trace)
        print(f"trace: {len(doc['traceEvents'])} events "
              f"({tracer.span_count()} request chains) -> {args.trace}")
    if args.metrics_out:
        text = engine.dump_metrics(args.metrics_out)
        print(f"metrics: {len(text.splitlines())} exposition lines "
              f"-> {args.metrics_out}")
    if args.snapshot_out:
        engine.dump_snapshot(args.snapshot_out,
                             source="repro_torch.launch.sortserve")
        print(f"snapshot -> {args.snapshot_out}")
    if args.warm_state:
        from repro_torch.sortserve import save_warm_state
        save_warm_state(engine, args.warm_state)
        print(f"warm state -> {args.warm_state}")
    if args.json:
        engine.dump_telemetry(args.json)
        print(f"telemetry -> {args.json}")
    else:
        print(json.dumps(telem["latency_s"]))

    if args.smoke:
        assert mismatches == 0, f"{mismatches} responses differ from oracle"
        assert len(backends_used) >= 2, f"only {backends_used} used"
        if faults is not None:
            ft = telem["fault"]
            assert ft["failures"] > 0, "chaos plan injected nothing"
            assert ft["quarantines"] > 0, "no bank was ever quarantined"
            print("CHAOS SMOKE OK")
        print("SMOKE OK")
    return 0 if mismatches == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
