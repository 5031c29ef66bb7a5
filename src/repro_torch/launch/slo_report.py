"""Render the per-traffic-class SLO burn-rate table.

    PYTHONPATH=src python -m repro_torch.launch.slo_report snapshot.json [more.json ...]
    PYTHONPATH=src python -m repro_torch.launch.slo_report --live \
        [--requests N] [--device cuda|cpu]

The torch port of ``scripts/slo_report.py``.  Reads one or more mergeable
telemetry snapshots (``engine.dump_snapshot`` /
``repro_torch.launch.sortserve --snapshot-out``, or the reference's), folds
them into a fleet view with :func:`repro_torch.obs.merge_snapshots`, and
prints per-class / per-SLI burn rates against the configured error
budgets.  A burn rate of 1.0 consumes the budget exactly at the
objective's pace; ``>= burn_threshold`` on both windows is the alerting
condition.  With ``--live`` a small overloaded workload is served through
the port's engine on ``--device`` (default ``cuda``) instead, so the table
is populated end to end.  Exit code 1 when any class is alerting or the
table is empty.
"""

from __future__ import annotations

import argparse
import sys


def render(slo: dict) -> int:
    if not slo:
        print("slo section is empty — the engine was built without "
              "EngineConfig(slo=...) targets, or no configured traffic "
              "class has seen a request yet")
        return 1
    print(f"{'class':<12} {'sli':<8} {'objective':>9} {'good':>7} {'bad':>6} "
          f"{'burn_long':>10} {'burn_short':>11} {'alerts':>7} {'state':>9}")
    alerting = False
    for cls in sorted(slo):
        for sli in ("latency", "shed"):
            row = slo[cls].get(sli)
            if row is None:
                continue
            state = "ALERTING" if row["alerting"] else "ok"
            alerting = alerting or row["alerting"]
            print(f"{cls:<12} {sli:<8} {row['objective']:>9.4f} "
                  f"{row['good']:>7} {row['bad']:>6} "
                  f"{row['burn_long']:>10.2f} {row['burn_short']:>11.2f} "
                  f"{row['alerts']:>7} {state:>9}")
        cfg = slo[cls].get("config", {})
        if cfg:
            print(f"{'':<12} windows: long={cfg['long_window_s']:.0f}s "
                  f"short={cfg['short_window_s']:.0f}s "
                  f"threshold={cfg['burn_threshold']:.1f}")
    return 1 if alerting else 0


def live_slo(requests: int, seed: int, device: str = "cuda") -> dict:
    from repro_torch.launch.sortserve import make_workload
    from repro_torch.obs import SLOTarget
    from repro_torch.sortserve import EngineConfig, SortServeEngine

    engine = SortServeEngine(EngineConfig(
        cache_size=0,
        slo={"live": SLOTarget(p99_latency_s=0.05)},
        device=device,
    ))
    session = engine.begin(traffic_class="live", strict=False)
    session.feed(make_workload(requests, min_len=16, max_len=512, seed=seed),
                 flush=True)
    session.drain()
    return engine.telemetry()["slo"]


def fleet_rows(merged) -> dict:
    """A merged snapshot's SLO table as ``render`` reads it.

    ``fleet_view()["slo"]`` re-evaluates each class's counts, alert state
    and burn rates, but leaves out what the live ``telemetry()["slo"]``
    section derives from the class's target: each SLI's objective, the
    latency threshold and the alerting windows.  They come from the
    section of a tracker on the snapshot's targets, the fleet view's
    values laid over it.  (``scripts/slo_report.py`` renders the fleet
    view as it stands and raises ``KeyError: 'objective'`` on any
    snapshot.)"""
    from repro_torch.obs import SLOTarget, SLOTracker

    targets = {cls: SLOTarget(**sub["target"])
               for cls, sub in merged.slo.items()}
    rows = SLOTracker(targets).section(merged.captured_at)
    for cls, per in merged.fleet_view().get("slo", {}).items():
        for sli, row in per.items():
            rows[cls][sli].update(row)
    return rows


def fleet_slo(paths: list[str]) -> dict:
    from repro_torch.obs import merge_snapshots
    from repro_torch.obs.aggregate import TelemetrySnapshot

    return fleet_rows(merge_snapshots(TelemetrySnapshot.load(p)
                                      for p in paths))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("snapshots", nargs="*",
                    help="telemetry snapshot JSONs from engine.dump_snapshot "
                         "/ launch.sortserve --snapshot-out (merged before "
                         "rendering)")
    ap.add_argument("--live", action="store_true",
                    help="serve a workload in-process instead of reading "
                         "snapshot files")
    ap.add_argument("--requests", type=int, default=40,
                    help="requests to serve with --live")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where --live serves: cuda (the kernels) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)

    if args.live:
        slo = live_slo(args.requests, args.seed, args.device)
    elif args.snapshots:
        slo = fleet_slo(args.snapshots)
    else:
        ap.error("give snapshot JSON path(s) or --live")
    return render(slo)


if __name__ == "__main__":
    sys.exit(main())
