"""Time the mesh backend's double buffer on the card.

    python3 scripts/mesh_prefetch.py [--repeats 3]

Needs an NVIDIA card.  Runs the ``distserve`` suite (48 requests through
the local and the mesh bank pool; its tiles queue, so the scheduler's
prefetch hook stages each successor's host-to-device copy from pinned
memory on a side stream) ``--repeats`` times with the double buffer on
and as often with it off (``ShardedColskipBackend.prefetch`` returning
False), alternating, and prints the rows' us per tile; then the host time
of one staging of an (8, 256) tile (pinned copy, side-stream copy, event)
against one plain ``torch.from_numpy(...).to("cuda")`` with the card
synchronised after each batch of 100.  Prints the card's name and power
limit first and last.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.benchmarks import distserve_bench  # noqa: E402
from repro_torch.sortserve.backends import ShardedColskipBackend  # noqa: E402


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"


def _host_us(fn, calls: int = 100) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mesh_prefetch: needs a CUDA device", file=sys.stderr)
        return 1
    card = _card()
    print(card)
    staged = ShardedColskipBackend.prefetch
    for _ in range(args.repeats):
        for mode in ("on", "off"):
            ShardedColskipBackend.prefetch = (
                staged if mode == "on" else lambda self, tile: False)
            rows = []
            distserve_bench.run(lambda n, us, d: rows.append((n, us, d)),
                                device="cuda")
            print(f"double buffer {mode}: " + "  ".join(
                f"{n} {us:.1f} us/tile" for n, us, _ in rows))
    ShardedColskipBackend.prefetch = staged
    backend = ShardedColskipBackend(device="cuda")
    data = np.random.default_rng(0).integers(
        0, 1 << 32, (8, 256), dtype=np.uint64).astype(np.uint32)
    print(f"one (8, 256) tile to the card: staged "
          f"{_host_us(lambda: backend._stage(data)):.2f} us, plain copy "
          f"{_host_us(lambda: torch.from_numpy(data).to('cuda')):.2f} us")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
