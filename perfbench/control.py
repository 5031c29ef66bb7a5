"""The control of ``correct``: the program's own control put in its place,
which the check must read as not correct.

    python perfbench/control.py --workload csk.uniform1024.backlog \
        --seeds 101,102,103 --seconds 10

Runs the cell as the benchmark does (same traffic, size and load) with the
cell's program altered by its ``control(obj, config)`` once set-up is done:
for the sort service, the column-skipping backends' ``run`` replaced by
the plain reference machine at one state-recording entry fewer than the
configuration states (k = 1 for the paper's k = 2): right values and
positions, wrong column reads and cycles.  Prints each run's compared
numbers and ``correct``.  The benchmark's own runs never do this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    from perfbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    manifest = harness.load_manifest(ROOT)
    cell = harness.find_cell(manifest, args.workload)
    config = harness.load_config(ROOT, manifest, cell["config"])
    program = harness.load_program(ROOT, manifest, cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(
            ROOT, args.workload, seed, args.seconds, False,
            patch=lambda obj: program.control(obj, config))
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
