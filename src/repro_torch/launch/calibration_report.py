"""Render the measured-vs-modeled calibration table from telemetry.

    PYTHONPATH=src python -m repro_torch.launch.calibration_report telemetry.json
    PYTHONPATH=src python -m repro_torch.launch.calibration_report --live \
        [--requests N] [--device cuda|cpu]

The torch port of ``scripts/calibration_report.py``.  Reads the
``calibration`` section of a dumped telemetry JSON (``engine.dump_telemetry``
/ ``repro_torch.launch.sortserve --json``, or the reference's), or with
``--live`` serves a two-round workload through the port's engine on
``--device`` (default ``cuda``: the colskip kernel and the radix kernel's
fused top-k entry; ``cpu``: their plain torch versions).  The cold round
builds, the warm round populates the table.  Reports per-(backend, width)
ratios: ``ratio = measured wall_s / modeled cycles at the 500 MHz part``.
A *drifting* ratio means the §V cost model no longer describes the machine
it routes for.  Exit code 1 when the table is empty.
"""

from __future__ import annotations

import argparse
import json
import sys


def render(calibration: dict) -> int:
    if not calibration:
        print("calibration table is empty — no warm execution with modeled "
              "cycles was recorded (run more than one round, or check that "
              "a cycle-modeling backend like colskip/jaxsort is enabled)")
        return 1
    print(f"{'backend':<14} {'width':>7} {'tiles':>6} {'wall_s':>11} "
          f"{'modeled_s':>11} {'ratio':>10}")
    for backend in sorted(calibration):
        for width, cell in sorted(calibration[backend].items(),
                                  key=lambda kv: int(kv[0])):
            print(f"{backend:<14} {width:>7} {cell['tiles']:>6} "
                  f"{cell['wall_s']:>11.4f} {cell['modeled_s']:>11.6f} "
                  f"{cell['ratio']:>10.1f}")
    return 0


def live_table(requests: int, seed: int, device: str = "cuda") -> dict:
    from repro_torch.launch.sortserve import make_workload
    from repro_torch.sortserve import EngineConfig, SortServeEngine

    engine = SortServeEngine(EngineConfig(cache_size=0, device=device))
    for rnd in range(2):            # round 2 runs warm -> calibration rows
        engine.submit(make_workload(requests, min_len=16, max_len=512,
                                    seed=seed + rnd))
    return engine.telemetry()["calibration"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("telemetry", nargs="?",
                    help="telemetry JSON from engine.dump_telemetry / "
                         "launch.sortserve --json")
    ap.add_argument("--live", action="store_true",
                    help="serve a two-round workload in-process instead of "
                         "reading a file")
    ap.add_argument("--requests", type=int, default=40,
                    help="requests per round with --live")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where --live serves: cuda (the kernels) or cpu "
                         "(their plain torch versions)")
    args = ap.parse_args(argv)

    if args.live:
        calib = live_table(args.requests, args.seed, args.device)
    elif args.telemetry:
        with open(args.telemetry) as f:
            calib = json.load(f).get("calibration", {})
    else:
        ap.error("give a telemetry JSON path or --live")
    return render(calib)


if __name__ == "__main__":
    sys.exit(main())
