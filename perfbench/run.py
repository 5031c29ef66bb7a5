"""Run one cell of the benchmark on the card and print its result line.

    python perfbench/run.py --workload csk.uniform1024.backlog --seed 1 \
        --seconds 10 --trace 0

Run from the root of a checkout that holds ``BENCHMARK.json``,
``perfbench/`` and the program, ``src/repro_torch``.  The kernel
libraries are built once into ``build/repro_torch/`` in the checkout and
opened from there by every later run.  Exits 2, printing no result, when
the card, the program or the cell is missing.
"""

import os
import sys
import time
from pathlib import Path

START = time.time()
ROOT = Path(__file__).resolve().parent.parent
# every cache the run writes stays at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.START_WALL = START
    sys.exit(harness.main(root=ROOT))
