"""The control of ``correct``: the plain reference in the program's place,
with one guarantee of the configuration broken.

    python perfbench/control.py --workload csk.uniform1024.backlog \
        --seeds 101,102,103 --seconds 10

Runs the cell as the benchmark does (same traffic, size and load) with the
column-skipping backend's ``run`` replaced by the reference machine of
:mod:`perfbench.reference.sortref` at one state-recording entry fewer than
the configuration states (k = 1 for the paper's k = 2): right values and
positions, wrong column reads and cycles.  The check must read it as not
correct.  Prints each run's compared numbers and ``correct``.  The
benchmark's own runs never do this.
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

MACHINES = ("colskip", "colskip_mesh")


def reference_in_place(engine, state_k: int) -> None:
    """Serve the machine backends' tiles by the plain reference at
    ``state_k`` state entries.  Column reads are kept by the row's sorted
    keys, which fix them."""
    import numpy as np

    from perfbench.reference.sortref import colskip_reads
    from repro_torch.sortserve.backends import TileResult
    w = engine.config.w
    memo: dict = {}

    def make_run(name):
        def run(tile):
            b, n = tile.data.shape
            stop = tile.k if tile.op == "kmin" else None
            out = n if stop is None else min(stop, n)
            vals = np.empty((b, out), np.uint32)
            idx = np.empty((b, out), np.int32)
            reads = np.empty(b, np.int64)
            cycles = np.empty(b, np.int64)
            for r in range(b):
                row = tile.data[r]
                order = np.argsort(row, kind="stable")[:out]
                vals[r], idx[r] = row[order], order
                key = (np.sort(row).tobytes(), stop)
                if key not in memo:
                    memo[key] = colskip_reads(row, w, state_k, stop)
                reads[r], cycles[r] = memo[key]
            return TileResult(vals, idx, reads, cycles, name,
                              meta={"exec_warm": True})
        return run

    for be in engine.backends:
        if be.name in MACHINES:
            be.run = make_run(be.name)


def main(argv=None) -> int:
    from perfbench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    manifest = harness.load_manifest(ROOT)
    cell = harness.find_cell(manifest, args.workload)
    state_k = harness.load_config(ROOT, manifest, cell["config"])["state_k"]
    for seed in (int(s) for s in args.seeds.split(",")):
        result = harness.run_cell(
            ROOT, args.workload, seed, args.seconds, False,
            patch=lambda e: reference_in_place(e, state_k - 1))
        print(json.dumps({"seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
