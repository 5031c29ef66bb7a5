"""Split the serving smoke's radix_topk tiles into kernel, glue and copies.

    python3 scripts/radix_profile.py [--repeats 3]

Needs an NVIDIA card and nvcc.  Serves the default smoke workload
(``repro_torch.launch.sortserve --smoke``: 200 requests, seed 0, lengths
64-4096, ``sim_width_cap`` 2048) on ``cuda`` and records every tile that
the radix_topk backend is handed.  Then it replays the recorded tiles
through the backend's own tile body (``backends._radix_select``, the
code the engine runs, unchanged) ``--repeats`` times, three times:

  0. as the engine runs it, with no profiler and no added
     synchronisation: the wall time a tile;
  1. stage by stage on the host clock: each stage the tile body calls is
     wrapped so that it ends in ``torch.cuda.synchronize()``, and its wall
     time is summed: the host-to-device copy of the tile (``_tensor``),
     the threshold kernel (``threshold_sortable``), ``exact_k_mask``,
     ``compact_sortable``, ``discriminating_planes`` (the CR telemetry),
     and the rest (the device-to-host copies of the results, the kmin
     complement);
  2. under ``torch.profiler`` (CPU and CUDA activities) with the same
     stages as ``record_function`` ranges and no added synchronisation:
     the device time of every kernel and copy by name, each range's host
     and device totals, the synchronising runtime calls, and the device's
     busy time a tile.  The idle share is 1 - busy / wall against the
     wall of replay 0 (the profiler slows the host, so its own wall is
     longer; the share against it is printed too).

It prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.radix_topk import ops as radix_ops  # noqa: E402
from repro_torch.launch import sortserve  # noqa: E402
from repro_torch.sortserve import backends  # noqa: E402

OUT = ROOT / "build" / "radix_profile"
# the stages of backends._radix_select: (module, attribute)
STAGES = {"h2d_tensor": (backends, "_tensor"),
          "threshold_kernel": (radix_ops, "threshold_sortable"),
          "exact_k_mask": (backends, "exact_k_mask"),
          "compact_sortable": (radix_ops, "compact_sortable"),
          "discriminating_planes": (backends, "discriminating_planes")}


def record_tiles() -> list:
    """(data, k, kmin) of every radix_topk tile the smoke serves."""
    tiles, body = [], backends._radix_select

    def recording(data, k, kmin, device):
        tiles.append((data.copy(), k, kmin))
        return body(data, k, kmin, device)

    backends._radix_select = recording
    try:
        OUT.mkdir(parents=True, exist_ok=True)
        rc = sortserve.main(["--smoke", "--device", "cuda", "--requests",
                             "200", "--min_len", "64", "--max_len", "4096",
                             "--seed", "0", "--sim_width_cap", "2048",
                             "--json", str(OUT / "smoke.json")])
    finally:
        backends._radix_select = body
    if rc != 0:
        raise RuntimeError(f"sortserve smoke returned {rc}")
    return tiles


def replay(tiles, repeats: int, dev) -> float:
    """Run the tile body on every tile ``repeats`` times; host seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        for data, k, kmin in tiles:
            backends._radix_select(data, k, kmin, dev)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def wrapped(wrap):
    """Replace every stage with wrap(name, fn); returns an undo."""
    saved = {name: getattr(mod, attr) for name, (mod, attr) in STAGES.items()}
    for name, (mod, attr) in STAGES.items():
        setattr(mod, attr, wrap(name, saved[name]))

    def undo():
        for name, (mod, attr) in STAGES.items():
            setattr(mod, attr, saved[name])
    return undo


def synced_split(tiles, repeats: int, dev) -> None:
    spent = {name: 0.0 for name in STAGES}

    def wrap(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t0
            return out
        return run

    undo = wrapped(wrap)
    try:
        total = replay(tiles, repeats, dev)
    finally:
        undo()
    per = 1e3 / (repeats * len(tiles))
    print(f"1. synchronised stage split, ms a tile (mean of {repeats} x "
          f"{len(tiles)} tiles; wall {total * per:.4f} ms a tile):")
    for name, s in spent.items():
        print(f"   {name:24s} {s * per:.4f}")
    print(f"   {'rest (d2h copies, glue)':24s} "
          f"{(total - sum(spent.values())) * per:.4f}")


def profiled_split(tiles, repeats: int, dev, plain_wall: float) -> None:
    """``plain_wall``: seconds of the same replay with no profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def wrap(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    undo = wrapped(wrap)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = replay(tiles, repeats, dev)
    finally:
        undo()
    n = repeats * len(tiles)
    avg = prof.key_averages()
    # device kernels and copies: rows with device time that are neither
    # torch operators, runtime calls nor the stage ranges
    kernels = [e for e in avg if e.device_time_total > 0
               and e.key not in STAGES and not e.key.startswith(("aten::",
                                                                 "cu"))]
    kernels.sort(key=lambda e: e.device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in kernels)
    print(f"2. torch.profiler over {n} tile replays: device busy "
          f"{busy / 1e3 / n:.4f} ms a tile; idle share "
          f"{1 - busy / 1e6 / plain_wall:.3f} of replay 0's wall "
          f"({plain_wall * 1e3 / n:.4f} ms a tile), "
          f"{1 - busy / 1e6 / wall:.3f} of the profiled wall "
          f"({wall * 1e3 / n:.4f} ms a tile)")
    print("   device time by kernel or copy, us a tile:")
    for e in kernels[:25]:
        print(f"   {e.device_time_total / n:10.3f}  x{e.count / n:.2f}  "
              f"{e.key[:100]}")
    print("   stages (record_function), us a tile: host total, device total")
    for e in avg:
        if e.key in STAGES:
            print(f"   {e.key:24s} {e.cpu_time_total / n:10.3f} "
                  f"{e.device_time_total / n:10.3f}")
    print("   synchronising runtime calls, host us a tile:")
    for e in avg:
        if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                     "cudaMemcpyAsync", "cudaMemcpy"):
            print(f"   {e.key:24s} {e.cpu_time_total / n:10.3f}  "
                  f"x{e.count / n:.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("radix_profile: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card)
    dev = torch.device("cuda")
    tiles = record_tiles()
    shapes = sorted({(d.shape, k, kmin) for d, k, kmin in tiles})
    print(f"{len(tiles)} radix_topk tiles in the smoke; (shape, k, kmin): "
          f"{shapes}")
    replay(tiles, 1, dev)                      # warm: builds, allocator
    plain_wall = replay(tiles, args.repeats, dev)
    print(f"0. replay with no profiler and no added synchronisation: wall "
          f"{plain_wall * 1e3 / (args.repeats * len(tiles)):.4f} ms a tile")
    synced_split(tiles, args.repeats, dev)
    profiled_split(tiles, args.repeats, dev, plain_wall)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
