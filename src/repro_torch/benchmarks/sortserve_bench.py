"""Sort-service throughput: requests/s vs batch size and backend.

The twin of the reference's ``benchmarks/sortserve_bench.py`` on the
port's engine (its backends on ``device``).  Each row serves a seeded
mixed-length workload through one forced backend (via request hints)
twice — the first pass builds every launcher, the second measures
steady-state serving.  Derived column reports throughput plus the
aggregate CR-cycle telemetry the engine exported.
"""

from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.sortserve import EngineConfig, SortRequest, SortServeEngine
from repro_torch.sortserve.backends import EXECUTOR_CACHE

from .paper_common import submit_timed


def _workload(rng, n_requests: int, op: str, lens=(64, 128, 256), kmax=16,
              backend=None):
    reqs = []
    for _ in range(n_requests):
        n = int(rng.choice(lens))
        payload = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        k = int(rng.integers(1, kmax + 1)) if op in ("topk", "kmin") else None
        reqs.append(SortRequest(op, payload, k=k, backend=backend))
    return reqs


def _serve(make_engine, reqs, device):
    """Warm the launchers with one engine, measure on a fresh one.

    The executor cache is process-global, so the second engine runs warm
    while its telemetry covers exactly the measured pass.
    """
    make_engine().submit(reqs)
    engine = make_engine()
    return submit_timed(engine, reqs, device), engine.telemetry()


def run(report, device="cuda"):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    for backend, op in [("colskip", "sort"), ("radix_topk", "topk"),
                        ("jaxsort", "sort")]:
        for batch in [16, 64]:
            make_engine = lambda: SortServeEngine(EngineConfig(
                backends=(backend,), tile_rows=8, banks=8,
                bank_width=256, sim_width_cap=4096, device=device))
            reqs = _workload(rng, batch, op, backend=backend)
            dt, telem = _serve(make_engine, reqs, dev)
            rps = batch / dt
            report(
                name=f"sortserve/{backend}_{op}_b{batch}",
                us_per_call=dt * 1e6 / batch,
                derived=(f"{rps:.0f}req/s crs={telem['column_reads']} "
                         f"cyc={telem['cycles_exact']} "
                         f"hit={telem['batcher']['bucket_hit_rate']:.2f}"),
            )

    # mixed workload through the cost policy (the serving configuration)
    make_engine = lambda: SortServeEngine(EngineConfig(
        backends=("colskip", "radix_topk", "jaxsort"), tile_rows=8,
        banks=8, bank_width=256, sim_width_cap=512, device=device))
    reqs = []
    for op in ("sort", "argsort", "topk", "kmin"):
        reqs += _workload(rng, 16, op)
    dt, telem = _serve(make_engine, reqs, dev)
    used = "+".join(sorted(telem["per_backend"]))
    report(
        name="sortserve/mixed_policy_b64",
        us_per_call=dt * 1e6 / len(reqs),
        derived=(f"{len(reqs) / dt:.0f}req/s backends={used} "
                 f"cyc={telem['cycles_exact']} "
                 + ("PASS" if len(telem["per_backend"]) >= 2 else "MISS")),
    )

    # cold vs warm: the same engine serving the same signatures twice —
    # pass 2 runs entirely on executor-cache hits (no launcher builds)
    EXECUTOR_CACHE.clear()
    engine = SortServeEngine(EngineConfig(
        backends=("colskip",), tile_rows=8, banks=8, bank_width=256,
        sim_width_cap=512, cache_size=0, device=device))
    cold = submit_timed(engine, _workload(rng, 32, "sort"), dev)
    warm = submit_timed(engine, _workload(rng, 32, "sort"), dev)
    ec = engine.telemetry()["executor_cache"]
    report(
        name="sortserve/colskip_cold_vs_warm_b32",
        us_per_call=warm * 1e6 / 32,
        derived=(f"cold_us={cold * 1e6 / 32:.0f} "
                 f"warm_speedup={cold / warm:.1f}x "
                 f"exec_hit_rate={ec['hit_rate']:.2f} "
                 + ("PASS" if ec["hits"] > 0 else "MISS")),
    )
