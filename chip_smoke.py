#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, any failure of which exits nonzero:

  1. print the card (``nvidia-smi`` name and power limit, torch's name);
  2. build every kernel from ``src/repro_torch/**/csrc/*.cu`` with nvcc
     (one process per source, started together) and print ``-Xptxas -v``;
  3. hold the colskip kernel against its plain torch version on the card
     ((8, N), N in {64, 256}, the five datasets; ``stop_after=16`` at
     N=2048) and against the numpy hardware model (N in {1024, 2048},
     w=32, k=2, the five datasets): values, order, CRs and cycles, exact;
  4. hold the radix threshold kernel against its plain version (thresholds
     and ``visited``, exact) at (8, N) for N in {128, 4096, 16384}, a
     ragged B and constant rows, on the float32 and the sortable entry;
  5. serve the default ``--smoke`` workload (200 requests, lengths
     64-4096, seed 0, sim_width_cap 2048) through
     ``repro_torch.launch.sortserve`` on ``cuda``, every response checked
     against the numpy oracle, with both kernels' launch counts reset just
     before and read just after: each must be above 0;
  6. time each kernel with CUDA events at a serving shape beside its plain
     version, the library yardstick where one exists and its bound, and
     print them as one JSON line (``{"kernels": [...]}``).  Radix is bound
     by one read of its tile; colskip by latency: the slowest row's chain
     of dependent steps times one dependent warp vote, timed here by the
     ``vote_chain`` probe;
  7. print ``{"ok": true, "device": {...}}`` as the last line.

Exact integer outputs: every tolerance is equality (``max_abs_err`` 0).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM device memory rate (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
# dependent warp votes timed to price one step of a colskip row's chain
VOTE_ROUNDS = 1 << 20


def _fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` calls (CUDA
    events, after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
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


def _rows(name: str, b: int, n: int, seed: int):
    """(b, n) uint32 rows of a paper dataset, one seed per row."""
    import numpy as np
    from repro_torch.core.datasets import make_dataset
    return np.stack([make_dataset(name, n, 32, seed=seed + r)
                     for r in range(b)]).astype(np.uint32)


def _max_err(a, b) -> int:
    """Largest |a - b| over two integer tensors of one shape (0 = equal)."""
    from repro_torch.core.bitmatrix import as_words
    if a.shape != b.shape or a.dtype != b.dtype:
        _fail(f"{tuple(a.shape)} {a.dtype} != {tuple(b.shape)} {b.dtype}")
    a, b = (as_words(t.cpu()) for t in (a, b))
    return int((a - b).abs().max()) if a.numel() else 0


def hold_colskip(torch, np) -> int:
    from repro_torch.core.colskip import colskip_sort
    from repro_torch.core.datasets import DATASETS
    from repro_torch.kernels.colskip import ops, ref
    dev = torch.device("cuda")
    worst = 0
    cases = [(n, None) for n in (64, 256)] + [(2048, 16)]
    for n, stop in cases:
        for i, name in enumerate(sorted(DATASETS)):
            x = torch.from_numpy(_rows(name, 8, n, 100 * i)).to(dev)
            got = ops.colskip_sort_batched(x, 32, 2, stop_after=stop)
            want = ref.sort_ref(x, 32, 2, stop)
            torch.cuda.synchronize()
            errs = [_max_err(g, w) for g, w in zip(got, want)]
            worst = max(worst, *errs)
            if any(errs):
                _fail(f"colskip kernel != plain at N={n} stop={stop} "
                      f"{name}: max errors (values, order, crs, cycles) "
                      f"{errs}")
        print(f"colskip kernel == plain version: (8, {n}) stop={stop}, "
              f"{len(DATASETS)} datasets")
    for n in (1024, 2048):
        for i, name in enumerate(sorted(DATASETS)):
            x = _rows(name, 4, n, 1000 + 10 * i)
            vals, order, crs, cyc = (
                t.cpu() for t in ops.colskip_sort_batched(
                    torch.from_numpy(x).to(dev), 32, 2))
            for r in range(x.shape[0]):
                hw = colskip_sort(x[r].astype(np.uint64), 32, 2)
                ok = (np.array_equal(vals[r].numpy(), hw.values.astype(np.uint32))
                      and np.array_equal(order[r].numpy(), hw.order)
                      and int(crs[r]) == hw.column_reads
                      and int(cyc[r]) == hw.cycles)
                if not ok:
                    _fail(f"colskip kernel != numpy hardware model at N={n} "
                          f"{name} row {r}: crs {int(crs[r])} vs "
                          f"{hw.column_reads}, cycles {int(cyc[r])} vs "
                          f"{hw.cycles}")
        print(f"colskip kernel == numpy hardware model: (4, {n}) w=32 k=2, "
              f"{len(DATASETS)} datasets")
    return worst


def hold_radix(torch, np) -> int:
    from repro_torch.core.topk import to_sortable_uint
    from repro_torch.core.bitmatrix import to_uint32
    from repro_torch.kernels.radix_topk import ops, ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    worst = 0
    cases = [(8, 128, 8), (8, 4096, 64), (8, 16384, 100), (13, 1000, 5)]
    for b, n, k in cases:
        x = (rng.normal(size=(b, n)) * 100).astype(np.float32)
        x[1] = np.float32(-2.5)                # a constant row
        if b > 8:
            x[8:] = np.float32(3.0)            # a constant ragged tile
        xf = torch.from_numpy(x).to(dev)
        u = to_uint32(to_sortable_uint(xf))
        for entry, got in (("float32", ops.threshold_f32(xf, k)),
                           ("sortable", ops.threshold_sortable(u, k))):
            want = ref.threshold_ref(to_sortable_uint(xf), k)
            torch.cuda.synchronize()
            errs = [_max_err(g, w) for g, w in zip(got, want)]
            worst = max(worst, *errs)
            if any(errs):
                _fail(f"radix kernel != plain at ({b}, {n}) k={k} {entry} "
                      f"entry: max errors (thresh, visited) {errs}")
        print(f"radix kernel == plain version: ({b}, {n}) k={k}, float32 and "
              "sortable entries")
    return worst


def serve(torch) -> dict:
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.launch import sortserve
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    telem_path = out / "smoke_telemetry.json"
    colskip_ops.reset_launches()
    radix_ops.reset_launches()
    t0 = time.perf_counter()
    rc = sortserve.main(["--smoke", "--device", "cuda", "--requests", "200",
                         "--min_len", "64", "--max_len", "4096", "--seed",
                         "0", "--sim_width_cap", "2048",
                         "--json", str(telem_path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"colskip": colskip_ops.launches,
                "radix_threshold": radix_ops.launches}
    if rc != 0:
        _fail(f"sortserve smoke returned {rc}")
    telem = json.loads(telem_path.read_text())
    if telem["verify_failures"]:
        _fail(f"{telem['verify_failures']} verify failures")
    print(f"sortserve.main took {wall:.3f} s wall for {telem['requests']} "
          f"requests on cuda (its serving time, printed above, plus the "
          f"oracle check, the telemetry dump and printing)")
    print("tiles and wall seconds per backend: " + json.dumps(
        {k: {"tiles": v["tiles"], "wall_s": v["wall_s"]}
         for k, v in sorted(telem["per_backend"].items())}))
    print(f"kernel launches in the smoke: {json.dumps(launches)}")
    for name, count in launches.items():
        if count <= 0:
            _fail(f"the smoke launched the {name} kernel {count} times")
    return launches


def measure(torch, np, launches: dict, errs: dict) -> list:
    from repro_torch.core.bitmatrix import as_words
    from repro_torch.kernels.colskip import ops as colskip_ops, ref as colskip_ref
    from repro_torch.kernels.radix_topk import ops as radix_ops, ref as radix_ref
    dev = torch.device("cuda")
    rows = []

    # colskip at the serving cap: one (8, 2048) tile of uniform 32-bit data
    b, n, w, k = 8, 2048, 32, 2
    x = torch.from_numpy(_rows("uniform", b, n, 5)).to(dev)
    _, _, crs, cyc = colskip_ops.colskip_sort_batched(x, w, k)
    crs, cyc = crs.cpu().long(), cyc.cpu().long()
    # bound: each row is a chain of dependent steps (a CR or a drain, each
    # at least one warp vote on the last verdict), so the least time is the
    # slowest row's cycles (CRs + drains, this run's) times one dependent
    # vote round, timed here on the card; bytes: the tile in, values +
    # order + 2 counters out
    slow = int(cyc.argmax())
    steps = int(cyc[slow])
    vote_ms = _time_ms(lambda: colskip_ops.vote_chain(VOTE_ROUNDS), 3)
    latency_ms = steps * vote_ms / VOTE_ROUNDS
    c_bytes = b * n * 4 + b * n * 8 + b * 8
    ms = _time_ms(lambda: colskip_ops.colskip_sort_batched(x, w, k), 10)
    plain_ms = _time_ms(lambda: colskip_ref.sort_ref(x, w, k), 1, warmup=0)
    rows.append(_row("colskip", "src/repro_torch/kernels/colskip/csrc/colskip.cu",
                     "src/repro/kernels/colskip/kernel.py:294",
                     launches["colskip"], errs["colskip"], ms, plain_ms,
                     c_bytes, latency_ms, None,
                     shape=f"({b}, {n}) uint32 w={w} k={k}",
                     crs_max_row=int(crs.max()),
                     slowest_row_crs=int(crs[slow]),
                     slowest_row_drains=steps - int(crs[slow]),
                     vote_round_ns=vote_ms * 1e6 / VOTE_ROUNDS))

    # radix at a serving shape: (8, 4096) sortable words, k=32 (the sortable
    # entry the serving radix backend launches)
    b, n, k = 8, 4096, 32
    rng = np.random.default_rng(11)
    u = torch.from_numpy(rng.integers(0, 1 << 32, (b, n), dtype=np.uint64)
                         .astype(np.uint32)).to(dev)
    _, visited = radix_ops.threshold_sortable(u, k)
    # bound: one read of the tile and the (B,) outputs; the descent's
    # word operations (map, compare, and, test, add per element per pass
    # of this design) are printed beside it, not taken as the bound
    passes = 1 + int(visited.max())
    r_bytes = b * n * 4 + b * 8
    ms = _time_ms(lambda: radix_ops.threshold_sortable(u, k), 50)
    plain_ms = _time_ms(lambda: radix_ref.threshold_ref(u, k), 3)
    keys = as_words(u)
    lib_ms = _time_ms(lambda: torch.topk(keys, k, dim=-1), 50)
    rows.append(_row("radix_threshold",
                     "src/repro_torch/kernels/radix_topk/csrc/radix_threshold.cu",
                     "src/repro/kernels/radix_topk/kernel.py:48",
                     launches["radix_threshold"], errs["radix_threshold"], ms,
                     plain_ms, r_bytes, None, lib_ms,
                     shape=f"({b}, {n}) sortable uint32 k={k}",
                     visited=int(visited.max()),
                     descent_operations=b * n * 5 * passes))
    return rows


def _row(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops_ms,
         library_ms, **extra) -> dict:
    """One entry of the ``kernels`` line; ``ops_ms`` is the operations'
    least time (None where the bytes alone bound the function)."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops_ms is not None and ops_ms > bytes_ms
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": ops_ms if by_ops else bytes_ms,
            "bound_by": "operations" if by_ops else "bytes",
            "library_ms": library_ms, "bytes": nbytes, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms, **extra}


def main() -> int:
    try:
        import torch
    except ImportError:
        _fail("torch is not installed")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").exists():
        _fail(f"{src / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(src))
    import numpy as np

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
          f"{kind} x{torch.cuda.device_count()}")

    # 2. build every kernel, all nvcc processes at once
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(_build.sources())} in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, log in sorted(logs.items()):
        print(f"--- nvcc -Xptxas -v: {name}\n{log.strip()}")

    # 3-4. hold each kernel against its plain version (and the hw model)
    errs = {"colskip": hold_colskip(torch, np),
            "radix_threshold": hold_radix(torch, np)}

    # 5. the main path: the sortserve smoke on the card
    launches = serve(torch)

    # 6. timings at serving shapes
    rows = measure(torch, np, launches, errs)
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"{r['name']}: {r['ms']:.4f} ms/launch at {r['shape']} "
              f"(plain {r['plain_ms']:.3f} ms, library {lib}, bound "
              f"{r['bound_ms']:.6f} ms by {r['bound_by']}), "
              f"{r['launches']} launches in the smoke")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
