"""Emit a tuned-hardware profile for ``launch.sortserve --hw-profile`` —
the twin of the reference's ``scripts/hw_tune.py``.

Serves the :mod:`~repro_torch.benchmarks.hw_bench` workload once at
fuse 2 in a fresh interpreter and writes a profile JSON with the
reference's keys:

    {
      "device_kind":   "...",            # torch.cuda.get_device_name
      "platform":      "gpu",            # "cpu" with --device cpu
      "xla_flags":     [],               # the port runs no XLA
      "compile_cache": "/path" | null,   # persistent kernel-library cache
      "priors":        [...],            # CostPolicy.load_priors rows
      "calibration":   [...],            # CalibrationTable.seed_rows rows
      "sweep":         [...]             # the one baseline measurement
    }

The reference sweeps candidate XLA flag sets and keeps the fastest; with
no XLA there is nothing to sweep, so ``sweep`` holds the baseline alone.
A serving process started as

    PYTHONPATH=src python -m repro_torch.launch.sortserve --smoke --mesh \\
        --hw-profile hwprofile.json

enables the compile cache and seeds the routing policy and calibration
table with the measured priors.

    PYTHONPATH=src python -m repro_torch.benchmarks.hw_tune \\
        --out hwprofile.json [--cache-dir DIR] [--requests 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.benchmarks.hw_bench import spawn


def profile_from(fused: dict, cache_dir: str | None) -> dict:
    """The profile of a fuse-2 ``hw_bench`` fused-worker document."""
    pf = fused["per_fuse"]["2"]
    ratios = [row["ratio"] for row in pf["calibration_rows"]
              if row["ratio"] > 0]
    return {
        "device_kind": fused["device_kind"],
        "platform": fused["platform"],
        "xla_flags": [],
        "compile_cache": cache_dir,
        "priors": pf["priors"],
        "calibration": pf["calibration_rows"],
        "sweep": [{"name": "baseline", "flags": [],
                   "us_per_tile": pf["wall_s"] / max(pf["tiles"], 1) * 1e6,
                   "ratio": sum(ratios) / len(ratios) if ratios else 0.0}],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="profile JSON path")
    ap.add_argument("--cache-dir", default="", dest="cache_dir",
                    help="persistent kernel-library directory to bake into "
                         "the profile (created on first use)")
    ap.add_argument("--requests", type=int, default=8,
                    help="workload size of the measurement (wall-clock knob)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the mesh kernel) or cpu (the plain mesh)")
    args = ap.parse_args(argv)

    prof = profile_from(spawn("fused", device=args.device, fuse_values=(2,),
                              n_requests=args.requests),
                        args.cache_dir or None)
    with open(args.out, "w") as f:
        json.dump(prof, f, indent=2)
        f.write("\n")
    print(f"hw_tune: device_kind={prof['device_kind']} best=baseline "
          f"({len(prof['sweep'])} candidates, "
          f"{len(prof['priors'])} priors, "
          f"{len(prof['calibration'])} calibration rows) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
