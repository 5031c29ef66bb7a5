"""Find the knee of an open-loop cell: the highest offered rate the service
sustains.

    python perfbench/sweep.py --workload csk.mixed.poisson --seed 7 \
        --seconds 10 --rates 1000,2000,3000

One process, the cell's program built and warmed once; then, for each rate in
turn, the cell's traffic at that rate for ``--seconds``.  A rate is
sustained when the requests left unanswered do not grow over the window
(those in flight at its end are no more than at its middle, plus one
front-door batch) and the 99th percentile of latency stays within
50 ms, the engine's default ``SLOTarget.p99_latency_s``.
The benchmark's runs do not call this; its result is written into the
mix's file as ``rate_per_s``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
P99_LIMIT_MS = 50.0
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def in_flight(window: dict, at: float) -> int:
    """Requests submitted by ``at`` and not yet answered then."""
    import numpy as np
    sub = window["t_submit"] <= at
    done = np.isfinite(window["t_done"]) & (window["t_done"] <= at)
    return int(sub.sum() - (sub & done).sum())


def main(argv=None) -> int:
    import numpy as np

    from perfbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", required=True,
                    help="comma-separated offered rates, requests a second")
    args = ap.parse_args(argv)
    manifest = harness.load_manifest(ROOT)
    cell = harness.find_cell(manifest, args.workload)
    config = harness.load_config(ROOT, manifest, cell["config"])
    program = harness.load_program(ROOT, manifest, cell["config"])
    mix = harness.load_mix(ROOT, cell["traffic"])
    gen = harness.generator(ROOT, mix["kind"])
    obj = program.build(config, "cuda", str(ROOT / "build" / "repro_torch"),
                        None)
    hooks = harness.Hooks(lambda: program.snapshot(obj), "cuda",
                          traced=False)
    rates = [float(r) for r in args.rates.split(",")]
    for i, rate in enumerate(rates):
        plan = gen.prepare(dict(mix, rate_per_s=rate), config,
                           args.seed + i, args.seconds)
        gen.warm(plan, obj, hooks)
        w = gen.drive(plan, obj, args.seconds, hooks)
        lat = w["t_done"] - w["t_due"]
        failed = np.array([r is None for r in w["responses"]])
        lat = np.where(failed | ~np.isfinite(lat), np.inf, lat) * 1e3
        mid, end = w["t0"] + args.seconds / 2, w["t_end"]
        row = {"rate_per_s": rate, "requests": len(lat),
               "failed": int(failed.sum()),
               "p50_ms": float(np.percentile(lat, 50)),
               "p95_ms": float(np.percentile(lat, 95)),
               "p99_ms": float(np.percentile(lat, 99)),
               "in_flight_mid": in_flight(w, mid),
               "in_flight_end": in_flight(w, end),
               "gen_late_p99_ms": float(np.percentile(
                   (w["t_submit"] - w["t_due"]) * 1e3, 99)),
               "gc_paused_s": hooks.gc.paused_s,
               "gc_longest_s": hooks.gc.longest_s,
               "gc_collections": hooks.gc.count}
        row["sustained"] = bool(
            row["failed"] == 0 and row["p99_ms"] <= P99_LIMIT_MS
            and row["in_flight_end"] <= row["in_flight_mid"]
            + int(mix["max_batch"]))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
