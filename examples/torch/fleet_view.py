"""Fleet observability demo on the PyTorch port: merge two engines'
telemetry snapshots into one fleet view, then drive a third engine into an
SLO breach and show the same deterministic ALERT in the exported metrics
and the Chrome trace (the twin of ``examples/fleet_view.py``).

Run:  PYTHONPATH=src python examples/torch/fleet_view.py [--device cpu]

Part 1 — **aggregation**: two engines serve disjoint workloads, dump
mergeable snapshots (``engine.dump_snapshot``), and the fold
(``merge_snapshots``) produces a fleet view whose every shared counter
equals the sum of the parts — asserted, not eyeballed.

Part 2 — **SLO breach**: a fake-clocked engine with a shed-mode watermark
policy, a ``Tracer``, and an armed ``SLOTarget`` is swamped past pool
capacity.  Shedding pushes the shed-SLI burn rate over the both-window
threshold, the tracker latches ALERTING, and the same event is visible
three ways: ``telemetry()["slo"]``, the ``sortserve_slo_*`` exposition
series (``fleet_metrics.prom``), and an ALERT instant on the
scheduler-events track of ``fleet_trace.json``.  Re-running alerts at the
identical instant — the tracker only moves at request/shed events on the
engine's injectable clock.  The two engines of part 1 serve on
``--device`` (the CUDA kernels on ``cuda``, their plain torch versions on
``cpu``); the files land in the working directory.
"""

import argparse

import numpy as np

from repro_torch.launch.sortserve import make_workload
from repro_torch.obs import (SLOTarget, Tracer, merge_snapshots,
                             parse_exposition)
from repro_torch.obs.aggregate import PREFIX, TelemetrySnapshot
from repro_torch.sortserve import (EngineConfig, SortRequest, SortServeEngine,
                                   WatermarkPolicy)


class FakeClock:
    """Deterministic wall clock the demo advances by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def serve_and_snapshot(name: str, seed: int, n: int,
                       device) -> TelemetrySnapshot:
    engine = SortServeEngine(EngineConfig(cache_size=0, device=device))
    engine.submit(make_workload(n, min_len=16, max_len=256, seed=seed))
    engine.dump_snapshot(f"snapshot_{name}.json", source=name)
    print(f"[{name}] served {n} requests -> snapshot_{name}.json")
    return TelemetrySnapshot.load(f"snapshot_{name}.json")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    # --- 1. two engines, one fleet view ----------------------------------
    snap_a = serve_and_snapshot("engine-a", seed=1, n=30, device=args.device)
    snap_b = serve_and_snapshot("engine-b", seed=2, n=50, device=args.device)
    fleet = merge_snapshots([snap_a, snap_b])
    for sid in sorted(set(snap_a.counters) | set(snap_b.counters)):
        want = snap_a.counters.get(sid, 0) + snap_b.counters.get(sid, 0)
        assert fleet.counters.get(sid, 0) == want, \
            f"{sid}: merged {fleet.counters.get(sid)} != sum {want}"
    view = fleet.fleet_view()
    print(f"[fleet] sources={view['sources']} "
          f"requests={view['requests']} (= 30 + 50) — every shared "
          f"counter equals the sum of the parts")

    # --- 2. deterministic SLO breach under overload ----------------------
    clock = FakeClock()
    tracer = Tracer()
    engine = SortServeEngine(
        EngineConfig(
            backends=("numpy",), tile_rows=4, min_bucket=8, banks=4,
            bank_width=64, bank_rows=4, sim_width_cap=128, cache_size=0,
            adaptive_policy=False, tracer=tracer,
            admission=WatermarkPolicy(high_watermark=1, shed=True),
            slo={"interactive": SLOTarget(p99_latency_s=0.05,
                                          shed_rate_target=0.01)},
            device=args.device,
        ),
        clock=clock)
    session = engine.begin(strict=False, traffic_class="interactive")
    rng = np.random.default_rng(0)
    reqs = [SortRequest("sort", rng.integers(0, 1 << 16, 16,
                                             dtype=np.int64).astype(np.uint32))
            for _ in range(40)]
    session.feed(reqs, flush=True)      # one burst over a 1-deep watermark
    session.drain()
    shed = session.take_failures()

    slo = engine.telemetry()["slo"]["interactive"]["shed"]
    assert slo["alerting"] and slo["alerts"] >= 1, slo
    print(f"[overload] {len(shed)} of {len(reqs)} requests shed -> "
          f"shed-SLI burn long={slo['burn_long']:.0f} "
          f"short={slo['burn_short']:.0f} (threshold 14.4): ALERTING")

    # the same alert, in the exposition ...
    text = engine.dump_metrics("fleet_metrics.prom")
    values, _ = parse_exposition(text)
    alerting = values[f'{PREFIX}slo_alerting'
                      f'{{sli="shed",traffic_class="interactive"}}']
    assert alerting == 1.0
    print(f"[metrics] sortserve_slo_alerting{{sli=shed}} = 1 in "
          f"{len(text.splitlines())} exposition lines -> fleet_metrics.prom")

    # ... and as an ALERT instant in the Chrome trace
    doc = engine.dump_trace("fleet_trace.json")
    alerts = [ev for ev in doc["traceEvents"] if ev["name"] == "ALERT"]
    assert alerts, "no ALERT instant in the trace"
    print(f"[trace] {len(alerts)} ALERT instant(s) on the scheduler-events "
          f"track -> fleet_trace.json (open at https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
