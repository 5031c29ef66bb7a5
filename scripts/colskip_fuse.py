"""Time the packed colskip kernel per fusion depth on the smoke's own tiles.

    python3 scripts/colskip_fuse.py [--fuse 1 2 4] [--iters 20]

Needs an NVIDIA card and nvcc (the port's build flags, ``sm_90a``).
Builds ``src/repro_torch/kernels/colskip/csrc/colskip.cu`` once for each
fusion depth F (``nvcc -DCOLSKIP_FUSE=F``, one process each, started
together) into ``build/colskip_fuse/`` and prints each build's
register-path spills.  Then it serves the default smoke workload
(``repro_torch.launch.sortserve --smoke``: 200 requests, seed 0, lengths
64-4096, ``sim_width_cap`` 2048) on ``cuda`` and records every tile that
the packed kernel is handed: its shape, state depth, ``stop_after`` and
each row's distinct values (the min searches of a full sort).  On each
recorded tile, and on the (8, 2048) uniform tile that ``chip_smoke.py``
times and the (8, 1024) mapreduce tile of the harness's ``packed_bench``,
it checks that every build's outputs equal the kernel's
(``colskip_sort_batched``) and times every build with CUDA events, in
the order of ``--fuse`` and then reversed, so that drift shows as a gap
between a build's two readings.  It prints one line per tile, the sums
over the smoke's tiles, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.datasets import make_dataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.colskip import ops  # noqa: E402
from repro_torch.launch import sortserve  # noqa: E402

OUT = ROOT / "build" / "colskip_fuse"


def build(fuses) -> dict:
    """F -> the kernel library built with COLSKIP_FUSE=F."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.sources()["colskip"]
    procs = {}
    for f in fuses:
        so = OUT / f"libcolskip_F{f}.so"
        procs[f] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DCOLSKIP_FUSE={f}",
             "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for f, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed at F={f}:\n{log}")
        lines = log.splitlines()
        spills = [re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", lines[i + 1]).groups()
                  for i, line in enumerate(lines[:-1])
                  if re.search(r"Function properties for \S*colskip_sort_"
                               r"kernelILi[12]E", line)]
        print(f"F={f}: register-path (WPL 1, 2) spills (stores, loads) "
              f"{spills}")
        lib = ctypes.CDLL(str(so))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.colskip_sort_launch.argtypes = [vp] * 5 + [i] * 6 + [vp]
        lib.colskip_sort_launch.restype = i
        if lib.colskip_fuse() != f:
            raise RuntimeError(f"library built at F={f} reports "
                               f"{lib.colskip_fuse()}")
        libs[f] = lib
    return libs


def record_smoke_tiles() -> list:
    """(x, w, k, stop) of every packed-kernel launch in the smoke."""
    tiles, launch = [], ops._launch

    def recording(x, w, k, stop, packed):
        if packed:
            tiles.append((x.clone(), w, k, stop))
        return launch(x, w, k, stop, packed)

    ops._launch = recording
    try:
        rc = sortserve.main(["--smoke", "--device", "cuda", "--requests",
                             "200", "--min_len", "64", "--max_len", "4096",
                             "--seed", "0", "--sim_width_cap", "2048",
                             "--json", str(OUT / "smoke.json")])
    finally:
        ops._launch = launch
    if rc != 0:
        raise RuntimeError(f"sortserve smoke returned {rc}")
    return tiles


def run(lib, x, w, k, stop):
    b, n = x.shape
    outs = (torch.empty((b, stop), dtype=torch.uint32, device=x.device),
            torch.empty((b, stop), dtype=torch.int32, device=x.device),
            torch.empty((b,), dtype=torch.int32, device=x.device),
            torch.empty((b,), dtype=torch.int32, device=x.device))
    err = lib.colskip_sort_launch(
        x.data_ptr(), *(o.data_ptr() for o in outs), b, n, w, k, stop, 1,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"colskip launch failed: CUDA error {err}")
    return outs


def time_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rows(name: str, b: int, n: int, seed: int) -> torch.Tensor:
    x = np.stack([make_dataset(name, n, 32, seed=seed + r)
                  for r in range(b)]).astype(np.uint32)
    return torch.from_numpy(x).cuda()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fuse", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("colskip_fuse: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "?"
    print(card)
    libs = build(args.fuse)
    tiles = [("smoke", t) for t in record_smoke_tiles()]
    tiles += [("uniform", (rows("uniform", 8, 2048, 5), 32, 2, 2048)),
              ("mapreduce", (rows("mapreduce", 8, 1024, 0), 32, 2, 1024))]
    order = list(args.fuse) + list(reversed(args.fuse))
    sums = {f: 0.0 for f in args.fuse}
    n_smoke = sum(src == "smoke" for src, _ in tiles)
    print(f"kernel's own F: {ops.fuse()}; {n_smoke} smoke tiles; ms per "
          f"launch, each build timed twice (order {order})")
    for i, (src, (x, w, k, stop)) in enumerate(tiles):
        want = ops.colskip_sort_batched(x, w, k, stop_after=stop)
        for f, lib in libs.items():
            got = run(lib, x, w, k, stop)
            if not all(torch.equal(g.view(torch.int32), v.view(torch.int32))
                       for g, v in zip(got, want)):
                raise RuntimeError(f"F={f} != the kernel on tile {i}")
        ms = {f: [] for f in args.fuse}
        for f in order:
            ms[f].append(time_ms(lambda: run(libs[f], x, w, k, stop),
                                 args.iters))
        words = x.view(torch.int32)
        distinct = [int(r.unique().numel()) for r in words]
        b, n = x.shape
        ones = int((words == -1).sum())        # the ascending ops' pad word
        print(f"{src:9s} ({b}, {n}) w={w} k={k} stop={stop} distinct/row "
              f"{min(distinct)}..{max(distinct)} all-ones words {ones}: " +
              "  ".join(f"F{f} " + "/".join(f"{t:.4f}" for t in ms[f])
                        for f in args.fuse))
        if src == "smoke":
            for f in args.fuse:
                sums[f] += sum(ms[f]) / len(ms[f])
    print("smoke tiles, summed mean ms: " + "  ".join(
        f"F{f} {t:.4f}" for f, t in sums.items()))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
