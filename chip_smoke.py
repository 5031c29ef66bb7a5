#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, any failure of which exits nonzero:

  1. print the card (``nvidia-smi`` name and power limit, torch's name);
  2. build every kernel from ``src/repro_torch/**/csrc/*.cu`` with nvcc
     (one process per source, started together), print ``-Xptxas -v``
     (this build's, or the report kept beside an earlier build) and read
     the spills of the packed colskip kernel's register path (WPL 1 and
     2): no report of them, or any spill, fails the run at its end;
  3. hold the colskip kernel on both mask carriers against the plain torch
     machines, which run on the host (on the card they are bound by
     launches and take several times longer) ((8, N), N in {64, 256},
     the five datasets; ``stop_after=16`` at N=2048, 4096 and 32768; k in
     {0, 8} at N=256), the dense kernel against the packed one, both
     against the numpy hardware model (N in {1024, 2048, 4096}, w=32, k=2,
     the five datasets), and the packed kernel against the model on its
     register path (N in {1000, 2000}) and its shared path (N in {4096,
     32768}) at k in {0, 1, 2, 8} and stop_after in {1, 16, N}, ragged B:
     values, order, CRs and cycles, exact;
  4. hold the radix threshold kernel against its plain version (thresholds
     and ``visited``, exact) at (8, N) for N in {128, 4096, 16384}, a
     ragged B and constant rows, on the float32 and the sortable entry;
     and the bitonic kernel against its plain network and ``np.sort``
     (exact) at the reference's test shapes, at N in {1, 2, 8}, at every
     cluster size (N = 2^11 .. 2^15), past one cluster (2^16, 2^20: the
     global-memory split) and at ragged B;
  5. the main path: serve the default ``--smoke`` workload (200 requests,
     lengths 64-4096, seed 0, sim_width_cap 2048) through
     ``repro_torch.launch.sortserve`` on ``cuda``, every response checked
     against the numpy oracle, with both serving kernels' launch counts
     reset just before and read just after: each must be above 0;
  6. the benchmark path: run the port's eight benchmark suites
     (``repro_torch.benchmarks.run --out``) on ``cuda`` with every launch
     count reset just before and read just after: no suite may fail, no
     correctness predicate may MISS (sorted output, threshold and index
     equality, CR parity), and every kernel must have launched; a MISS of
     a performance or paper band is printed as a finding;
  7. time each kernel with CUDA events at a path shape beside its plain
     version, the library yardstick where one exists and its bound, and
     print them as one JSON line (``{"kernels": [...]}``).  Radix is bound
     by one read of its tile; bitonic by the larger of its bytes and its
     compare-exchanges at the int32 rate, with its device time split from
     the host's enqueue; colskip (both carriers) by latency: the slowest
     row's min searches (one per distinct value) times one dependent warp
     round, the cheaper of the ``vote_chain`` and ``redux_chain`` probes,
     with the older chain (CRs + drains rounds) as ``unfused_chain_ms``;
  8. print ``{"ok": true, "device": {...}}`` as the last line.

Exact integer outputs: every tolerance is equality (``max_abs_err`` 0).
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM device memory rate (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
# H100 SXM int32 rate: 64 int32 lanes an SM x 132 SMs x 1.98 GHz boost
# (Hopper white paper), a quarter of the 67 TFLOP/s float32 rate, which
# counts a fused multiply-add as two
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# dependent warp rounds timed to price one step of a colskip row's chain
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


def _queued_ms(torch, fn, iters: int, busy) -> tuple:
    """(device ms, host enqueue ms) per call of ``fn()``: ``busy()`` (a
    kernel of some milliseconds) is queued first, so the ``iters`` calls
    are all enqueued before the card reaches them and then run back to
    back; CUDA events around them time the device, the host clock the
    enqueue."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    busy()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host * 1e3 / iters


def _searches(x) -> list:
    """Min searches each row of a full sort makes: its distinct values."""
    from repro_torch.core.bitmatrix import as_words
    return [int(r.unique().numel()) for r in as_words(x.cpu())]


def register_path_spills(log: str) -> dict:
    """Spill bytes (stores, loads) of each instance of the packed colskip
    kernel's register path (WPL 1 and 2) in an ``-Xptxas -v`` log."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines[:-1]):
        m = re.search(
            r"Function properties for (\S*colskip_sort_kernelILi[12]E\S*)",
            line)
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       lines[i + 1])
        if m and sp:
            out[m.group(1)] = (int(sp.group(1)), int(sp.group(2)))
    return out


def _host_ms(fn) -> float:
    """Host time of one call of ``fn()`` in ms (a plain version on the
    CPU)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


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


def _hold(what: str, got, want) -> int:
    """Largest error over the paired outputs; fails on any nonzero."""
    errs = [_max_err(g, w) for g, w in zip(got, want)]
    if any(errs):
        _fail(f"{what}: max errors per output {errs}")
    return max(errs)


def _hold_model(np, colskip_sort, row, w, k, stop, r, out, what) -> None:
    """Row ``r`` of a kernel's outputs against the numpy hardware model."""
    vals, order, crs, cyc = out
    hw = colskip_sort(row.astype(np.uint64), w, k, stop_after=stop)
    ok = (np.array_equal(vals[r].numpy(), hw.values.astype(np.uint32))
          and np.array_equal(order[r].numpy(), hw.order)
          and int(crs[r]) == hw.column_reads and int(cyc[r]) == hw.cycles)
    if not ok:
        _fail(f"{what} row {r} != numpy hardware model: crs {int(crs[r])} "
              f"vs {hw.column_reads}, cycles {int(cyc[r])} vs {hw.cycles}")


def hold_colskip(torch, np) -> dict:
    """Both carriers' kernels against the plain machines (on the host, on
    the same inputs), each other and the numpy hardware model; returns the
    worst error per carrier."""
    from repro_torch.core.colskip import colskip_sort
    from repro_torch.core.datasets import DATASETS
    from repro_torch.kernels.colskip import ops, ref
    dev = torch.device("cuda")
    worst = {"colskip": 0, "colskip_dense": 0}

    def both(x, k, stop, what):
        packed = ops.colskip_sort_batched(x, 32, k, stop_after=stop)
        dense = ops.colskip_sort_batched(x, 32, k, stop_after=stop,
                                         packed=False)
        x_host = x.cpu()
        plain = ref.sort_ref(x_host, 32, k, stop)
        plain_dense = ref.sort_ref(x_host, 32, k, stop, packed=False)
        torch.cuda.synchronize()
        worst["colskip"] = max(worst["colskip"], _hold(
            f"colskip kernel != plain at {what}", packed, plain))
        worst["colskip_dense"] = max(
            worst["colskip_dense"],
            _hold(f"dense colskip kernel != plain dense at {what}", dense,
                  plain_dense),
            _hold(f"dense colskip kernel != packed kernel at {what}", dense,
                  packed))

    for n, stop in [(64, None), (256, None), (2048, 16)]:
        for i, name in enumerate(sorted(DATASETS)):
            x = torch.from_numpy(_rows(name, 8, n, 100 * i)).to(dev)
            both(x, 2, stop, f"(8, {n}) stop={stop} {name}")
        print(f"colskip kernels (packed, dense) == plain versions: (8, {n}) "
              f"stop={stop}, {len(DATASETS)} datasets")
    for k in (0, 8):
        x = torch.from_numpy(_rows("mapreduce", 8, 256, 500 + k)).to(dev)
        both(x, k, None, f"(8, 256) k={k} mapreduce")
    print("colskip kernels (packed, dense) == plain versions: (8, 256) "
          "k in {0, 8}, mapreduce")
    for n in (1024, 2048, 4096):
        for i, name in enumerate(sorted(DATASETS)):
            x = _rows(name, 4 if n < 4096 else 2, n, 1000 + 10 * i)
            xt = torch.from_numpy(x).to(dev)
            outs = {carrier: [t.cpu() for t in ops.colskip_sort_batched(
                xt, 32, 2, packed=carrier == "packed")]
                for carrier in ("packed", "dense")}
            for r in range(x.shape[0]):
                for carrier, out in outs.items():
                    _hold_model(np, colskip_sort, x[r], 32, 2, None, r, out,
                                f"{carrier} colskip kernel at N={n} {name}")
        print(f"colskip kernels (packed, dense) == numpy hardware model: "
              f"({4 if n < 4096 else 2}, {n}) w=32 k=2, {len(DATASETS)} "
              "datasets")
    # the packed kernel's register path (WPL 1, 2) and shared path (WPL 4
    # to 32) at every state depth and early exit, ragged B
    for b, n in ((3, 1000), (3, 2000), (2, 4096), (1, 32768)):
        for k in (0, 1, 2, 8):
            for stop in (1, 16, None):
                if n == 32768 and stop is None and k != 2:
                    continue                   # one full 32768 row (k=2)
                x = _rows("uniform" if k % 2 else "mapreduce", b, n, 77 + k)
                out = [t.cpu() for t in ops.colskip_sort_batched(
                    torch.from_numpy(x).to(dev), 32, k, stop_after=stop)]
                for r in range(b):
                    _hold_model(np, colskip_sort, x[r], 32, k, stop, r, out,
                                f"packed colskip kernel at N={n} k={k} "
                                f"stop={stop}")
        print(f"packed colskip kernel == numpy hardware model: ({b}, {n}) "
              "w=32, k in {0, 1, 2, 8}, stop_after in {1, 16, N}")
    for b, n in ((5, 4096), (3, 32768)):
        x = torch.from_numpy(_rows("normal", b, n, 900 + b)).to(dev)
        worst["colskip"] = max(worst["colskip"], _hold(
            f"colskip kernel != plain at ({b}, {n}) stop=16",
            ops.colskip_sort_batched(x, 32, 2, stop_after=16),
            ref.sort_ref(x.cpu(), 32, 2, 16)))
    print("packed colskip kernel == plain version: (5, 4096) and (3, 32768) "
          "stop=16, normal")
    return worst


def hold_bitonic(torch, np) -> int:
    from repro_torch.kernels.bitonic import ops, ref
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    worst = 0
    # the reference's test shapes, the edge widths, the global-memory split
    # (N > 2^15) and ragged batches; one duplicate-heavy case
    cases = [(3, 64), (5, 256), (2, 1024), (7, 128), (4, 1), (3, 2),
             (3, 1 << 15), (5, 1 << 16), (2, 1 << 20), (13, 4096),
             (3, 1 << 11), (5, 1 << 12), (3, 1 << 13), (9, 1 << 14), (4, 8)]
    for b, n in cases:
        x = rng.integers(0, 1 << 32, (b, n), dtype=np.uint64).astype(np.uint32)
        if n == 4096:
            x %= 7
        xt = torch.from_numpy(x).to(dev)
        got = ops.bitonic_sort(xt)
        want = ref.sort_ref(xt)
        torch.cuda.synchronize()
        worst = max(worst, _hold(f"bitonic kernel != plain at ({b}, {n})",
                                 [got], [want]))
        npw = torch.from_numpy(np.sort(x, axis=-1))
        worst = max(worst, _hold(f"bitonic kernel != np.sort at ({b}, {n})",
                                 [got], [npw]))
    print(f"bitonic kernel == plain network == np.sort: {cases}")
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


# Rows whose PASS is a correctness predicate of the output (sorted values,
# threshold or index equality, carrier parity); every other PASS/MISS is a
# performance or paper band.
CORRECTNESS_ROWS = ("kernel/", "serving/")


def bench(torch) -> dict:
    """The benchmark path on the card; returns every kernel's launches."""
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.kernels.bitonic import ops as bitonic_ops
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.kernels.radix_topk import ops as radix_ops
    out = ROOT / "build" / "chip_smoke" / "bench.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    for ops in (colskip_ops, radix_ops, bitonic_ops):
        ops.reset_launches()
    t0 = time.perf_counter()
    rc = bench_run.main(["--device", "cuda", "--out", str(out)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"colskip": colskip_ops.launches,
                "colskip_dense": colskip_ops.launches_dense,
                "radix_threshold": radix_ops.launches,
                "bitonic": bitonic_ops.launches}
    doc = json.loads(out.read_text())
    print(f"benchmark suites took {wall:.3f} s wall on cuda: "
          f"{len(doc['rows'])} rows, {doc['band_misses']} band misses, "
          f"{len(doc['errors'])} suite errors")
    print(f"kernel launches in the benchmark run: {json.dumps(launches)}")
    if rc != 0 or doc["errors"]:
        _fail(f"benchmark suites failed: {doc['errors']}")
    for row in doc["rows"]:
        if "MISS" not in row["derived"]:
            continue
        broken = (row["name"].startswith(CORRECTNESS_ROWS)
                  or "cr_parity=BROKEN" in row["derived"])
        if broken:
            _fail(f"benchmark correctness MISS: {row['name']} "
                  f"{row['derived']}")
        print(f"finding: band MISS on the card: {row['name']} "
              f"{row['derived']}")
    for name, count in launches.items():
        if count <= 0:
            _fail(f"the benchmark run launched the {name} kernel {count} "
                  "times")
    return launches


def measure(torch, np, launches: dict, bench_launches: dict,
            errs: dict) -> list:
    """The ``kernels`` rows.  ``launches`` are the serving path's (colskip,
    radix), ``bench_launches`` the benchmark path's (dense colskip,
    bitonic): each kernel's count from the path that carries it."""
    from repro_torch.core.bitmatrix import as_words
    from repro_torch.kernels.bitonic import ops as bitonic_ops, ref as bitonic_ref
    from repro_torch.kernels.colskip import ops as colskip_ops, ref as colskip_ref
    from repro_torch.kernels.radix_topk import ops as radix_ops, ref as radix_ref
    dev = torch.device("cuda")
    rows = []

    # colskip at the serving cap: one (8, 2048) tile of uniform 32-bit data.
    # Its plain machine is timed once on the host: on the card it is bound
    # by its many small launches (26 s for this tile, PERF.md)
    b, n, w, k = 8, 2048, 32, 2
    x = torch.from_numpy(_rows("uniform", b, n, 5)).to(dev)
    want = colskip_ops.colskip_sort_batched(x, w, k)
    crs, cyc = want[2].cpu().long(), want[3].cpu().long()
    # bound: a min search reads the sorted mask the last drain wrote, so a
    # row costs at least one dependent warp round per search, whatever the
    # design; with stop = N a row makes one search per distinct value.  The
    # round is the cheaper of the two probes, timed here on the card.  The
    # older chain (one round per CR or drain step, PR 11) is printed
    # beside it as unfused_chain_ms.  Bytes: the tile in, values + order +
    # 2 counters out
    vote_ms = _time_ms(lambda: colskip_ops.vote_chain(VOTE_ROUNDS), 3)
    redux_ms = _time_ms(lambda: colskip_ops.redux_chain(VOTE_ROUNDS), 3)
    round_ms = min(vote_ms, redux_ms) / VOTE_ROUNDS
    searches = _searches(x)
    slow = int(cyc.argmax())
    c_bytes = b * n * 4 + b * n * 8 + b * 8
    ms = _time_ms(lambda: colskip_ops.colskip_sort_batched(x, w, k), 10)
    plain_ms = _host_ms(lambda: colskip_ref.sort_ref(x.cpu(), w, k))
    rows.append(_row("colskip", "src/repro_torch/kernels/colskip/csrc/colskip.cu",
                     "src/repro/kernels/colskip/kernel.py:294",
                     launches["colskip"], errs["colskip"], ms, plain_ms,
                     c_bytes, max(searches) * round_ms, None,
                     shape=f"({b}, {n}) uint32 w={w} k={k} uniform",
                     plain_device="cpu", fuse=colskip_ops.fuse(),
                     verdicts="patterns", reduction="__reduce_or_sync",
                     searches_max_row=max(searches),
                     crs_max_row=int(crs.max()),
                     slowest_row_crs=int(crs[slow]),
                     slowest_row_drains=int(cyc[slow] - crs[slow]),
                     unfused_chain_ms=int(cyc[slow]) * vote_ms / VOTE_ROUNDS,
                     ns_per_cr=ms * 1e6 / int(crs.max()),
                     vote_round_ns=vote_ms * 1e6 / VOTE_ROUNDS,
                     redux_round_ns=redux_ms * 1e6 / VOTE_ROUNDS))

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

    # dense colskip at the packed_bench shape: (8, 1024) mapreduce, beside
    # the packed kernel on the same tile.  Same function, same bound
    # (searches x one round).
    b, n, w, k = 8, 1024, 32, 2
    x = torch.from_numpy(_rows("mapreduce", b, n, 0)).to(dev)
    _, _, crs, cyc = colskip_ops.colskip_sort_batched(x, w, k, packed=False)
    crs, cyc = crs.cpu().long(), cyc.cpu().long()
    slow = int(cyc.argmax())
    searches = _searches(x)
    ms = _time_ms(lambda: colskip_ops.colskip_sort_batched(
        x, w, k, packed=False), 10)
    packed_ms = _time_ms(lambda: colskip_ops.colskip_sort_batched(x, w, k),
                         10)
    plain_ms = _host_ms(lambda: colskip_ref.sort_ref(x.cpu(), w, k,
                                                     packed=False))
    rows.append(_row("colskip_dense",
                     "src/repro_torch/kernels/colskip/csrc/colskip.cu",
                     "src/repro/kernels/colskip/kernel.py:229",
                     bench_launches["colskip_dense"], errs["colskip_dense"],
                     ms, plain_ms, b * n * 4 + b * n * 8 + b * 8,
                     max(searches) * round_ms, None,
                     shape=f"({b}, {n}) uint32 w={w} k={k} mapreduce",
                     packed_ms=packed_ms, plain_device="cpu",
                     searches_max_row=max(searches),
                     slowest_row_crs=int(crs[slow]),
                     slowest_row_drains=int(cyc[slow] - crs[slow]),
                     unfused_chain_ms=int(cyc[slow]) * vote_ms / VOTE_ROUNDS,
                     vote_round_ns=vote_ms * 1e6 / VOTE_ROUNDS))

    # bitonic at the harness shape (2, 1024) mapreduce and at (8, 32768)
    # uniform words: bound by the larger of one read and one write of the
    # rows and the compare-exchanges (a min and a max each) at the int32
    # rate; the yardstick sorts an int64 copy made outside the timing.  The
    # device time is split from the host's enqueue: calls queued behind a
    # busy kernel run back to back on the card
    for name, b, n, data in (("bitonic", 2, 1024, "mapreduce"),
                             ("bitonic_32768", 8, 1 << 15, "uniform")):
        x = torch.from_numpy(_rows(data, b, n, 1)).to(dev)
        iters = 200 if n <= 1024 else 50
        ms = _time_ms(lambda: bitonic_ops.bitonic_sort(x), iters)
        device_ms, enqueue_ms = _queued_ms(
            torch, lambda: bitonic_ops.bitonic_sort(x), iters,
            lambda: colskip_ops.vote_chain(VOTE_ROUNDS))
        plain_ms = _time_ms(lambda: bitonic_ref.sort_ref(x), 3)
        keys = as_words(x)
        lib_ms = _time_ms(lambda: torch.sort(keys, dim=-1), iters)
        lib_device_ms, _ = _queued_ms(
            torch, lambda: torch.sort(keys, dim=-1), iters,
            lambda: colskip_ops.vote_chain(VOTE_ROUNDS))
        exchanges = b * (n // 2) * bitonic_ref.n_passes(n)
        rows.append(_row(name, "src/repro_torch/kernels/bitonic/csrc/bitonic.cu",
                         "src/repro/kernels/bitonic/kernel.py:29",
                         bench_launches["bitonic"], errs["bitonic"], ms,
                         plain_ms, 2 * b * n * 4,
                         2 * exchanges / INT32_OPS_PER_S * 1e3, lib_ms,
                         shape=f"({b}, {n}) uint32 {data}",
                         compare_exchanges=exchanges,
                         device_ms=device_ms, host_enqueue_ms=enqueue_ms,
                         library_device_ms=lib_device_ms))
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
    spills = register_path_spills(logs.get("colskip", ""))
    print(f"colskip register-path spills (stores, loads): "
          f"{json.dumps(spills)}")
    if not spills:
        _fail("no register-path instance in the colskip ptxas report")

    # 3-4. hold each kernel against its plain version (and the hw model)
    t0 = time.perf_counter()
    errs = {**hold_colskip(torch, np),
            "radix_threshold": hold_radix(torch, np),
            "bitonic": hold_bitonic(torch, np)}
    print(f"phases 3-4 (holds) took {time.perf_counter() - t0:.1f} s")

    # 5. the main path: the sortserve smoke on the card
    launches = serve(torch)

    # 6. the benchmark path: the port's eight suites on the card
    bench_launches = bench(torch)

    # 7. timings at the paths' shapes
    t0 = time.perf_counter()
    rows = measure(torch, np, launches, bench_launches, errs)
    print(f"phase 7 (timings) took {time.perf_counter() - t0:.1f} s")
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"{r['name']}: {r['ms']:.4f} ms/launch at {r['shape']} "
              f"(plain {r['plain_ms']:.3f} ms, library {lib}, bound "
              f"{r['bound_ms']:.6f} ms by {r['bound_by']}), "
              f"{r['launches']} launches on its path")
    spilled = {k: v for k, v in spills.items() if any(v)}
    if spilled:
        _fail(f"the colskip register path spills: {spilled}")
    # 8. the card again, the timings, and the verdict as the last line
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
