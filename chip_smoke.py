#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, any failure of which exits nonzero:

  1. print the card (``nvidia-smi`` name and power limit, torch's name);
  2. build every kernel from ``src/repro_torch/**/csrc/*.cu`` with nvcc
     (one process per source, started together), print ``-Xptxas -v``
     (this build's, or the report kept beside an earlier build) and read
     the spills of the colskip kernels' register instances (packed: WPL 1
     and 2; dense: C = 4, 8, 16 elements a thread): no report of either,
     or any spill, fails the run at its end;
  3. hold the colskip kernel on both mask carriers against the plain torch
     machines, which run on the host (on the card they are bound by
     launches and take several times longer) ((8, N), N in {64, 256},
     the five datasets; ``stop_after=16`` at N=2048, 4096 and 32768; k in
     {0, 8} at N=256), the dense kernel against the packed one, both
     against the numpy hardware model (N in {1024, 2048, 4096}, w=32, k=2,
     the five datasets), the packed kernel against the model on its
     register path (N in {1000, 2000}) and its shared path (N in {4096,
     32768}), and the dense kernel against the plain dense machine and
     the packed kernel on every instance (N in {100, 256, 500, 1000, 2000}
     in registers, 4096 rolled), all at k in {0, 1, 2, 8} and stop_after
     in {1, 16, N}, ragged B: values, order, CRs and cycles, exact;
  4. hold the radix threshold kernel against its plain version (thresholds
     and ``visited``, exact) at (8, N) for N in {128, 4096, 16384}, k = N,
     a ragged B and constant rows, on the float32 and the sortable entry,
     and on the streamed instance ((1, 65536), (3, 20000), sortable);
     and the bitonic kernel against its plain network and ``np.sort``
     (exact) at the reference's test shapes, at N in {1, 2, 8}, at every
     cluster size (N = 2^11 .. 2^15), past one cluster (2^16, 2^20: the
     global-memory split) and at ragged B;
     Then hold the mesh kernels of both carriers (``colskip_mesh.cu``: a
     thread-block cluster of D CTAs a row, each a bank of the §IV
     manager) against the local packed kernel (exact) for D in {2, 4, 8}
     up to N = D x 2048 (and shards on the shared-memory instances), fuse
     in {1, 2, 4}, k in {0, 2, 8}, stop_after in {1, 16, N}, against the
     plain mesh on the host at widths up to 256 and against the numpy
     hardware model; the round count per row must stay within the
     reference's static account;
  5. the main path: serve the default ``--smoke`` workload (200 requests,
     lengths 64-4096, seed 0, sim_width_cap 2048) through
     ``repro_torch.launch.sortserve`` on ``cuda``, every response checked
     against the numpy oracle, with both serving kernels' launch counts
     reset just before and read just after: each must be above 0.  Then
     the same workload with ``--mesh --fuse 2`` and with ``--mesh --dense
     --fuse 2`` (the carrier's mesh kernel's launch count must be above 0;
     the local fallback's, the ``collectives`` section and the kernel's
     own rounds beside the static account are printed), the double buffer
     on the card (six tiles at once: 4 copies staged on the side stream, 4
     hits), and a ``--replicas 2 --rolling-restart --warm-state`` fleet (0
     sheds, 2 restarts), run twice so the second run reloads the artifact
     the first wrote;
  6. the benchmark path: run the port's ten benchmark suites
     (``repro_torch.benchmarks.run --out``) on ``cuda`` with every launch
     count reset just before and read just after: no suite may fail, no
     correctness predicate may MISS (sorted output, threshold and index
     equality, CR parity, ``distserve``'s ``cycle_parity=ok``), and every
     kernel must have launched; a MISS of a performance or paper band is
     printed as a finding; the rows of the redesigned dense colskip and
     radix kernels are printed beside their times before that redesign;
  7. time each kernel with CUDA events at a path shape beside its plain
     version, the library yardstick where one exists and its bound, and
     print them as one JSON line (``{"kernels": [...]}``) of this run's
     numbers; each kernel's time before the dense and radix redesign is
     printed on a line of its own.
     Radix is bound by one read of its tile, with the card's launch floor
     (an empty kernel launched as one tile) and the kernel's pass count
     beside it; bitonic by the larger of its bytes and its
     compare-exchanges at the int32 rate, with its device time split from
     the host's enqueue; colskip (both carriers) by latency: the slowest
     row's min searches (one per distinct value) times one dependent warp
     round, the cheaper of the ``vote_chain`` and ``redux_chain`` probes,
     with the older chain (CRs + drains rounds) as ``unfused_chain_ms``;
     each carrier's mesh kernel at (8, 2048) uniform for D in {2, 4, 8} x
     fuse in {1, 2, 4} beside its local kernel on the same tile, bound by
     the slowest row's min searches times one dependent cross-bank round
     (the ``mesh_chain`` probe at that D);
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
# dependent cross-bank rounds timed to price one step of a mesh row's chain
MESH_ROUNDS = 1 << 16
# each kernel row's time (ms) before the dense colskip carrier and the
# radix kernel were redesigned, printed on its own line beside this run's
# and kept out of the kernels line: one H100 80GB HBM3 at 700 W (PERF.md)
BEFORE_MS = {"colskip": 1.6238, "radix_threshold": 0.05051,
           "colskip_dense": 12.888, "bitonic": 0.02313,
           "bitonic_32768": 0.05264}
# harness rows (us_per_call) of the redesigned kernels, as they read
# before the redesign on the same card
BEFORE_ROWS_US = {"kernel/radix_topk/router_probs": 50.3,
                "kernel/radix_topk/logits_wide": 79.1,
                "serving/topk64_vocab32256": 3683.0,
                "serving/topk64_vocab151936": 4444.3,
                "serving/topk64_vocab262144": 3144.5,
                "packed/colskip_sim_1024/packed": 725.1,
                "packed/colskip_sim_1024/dense": 13527.4}


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
    """Spill bytes (stores, loads) of each register-path instance of the
    colskip kernels in an ``-Xptxas -v`` log: the packed kernel's (WPL 1
    and 2) and the dense carrier's (C >= 4 elements a thread; C = 0
    is its rolled shared-memory instance)."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines[:-1]):
        m = re.search(
            r"Function properties for (\S*(?:colskip_sort_kernelILi[12]E"
            r"|colskip_dense_kernelILi[1-9]\d*E)\S*)", line)
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
    # the dense carrier on every instance: registers at C = 4, 8, 16
    # elements a thread (4 warps a row, N up to 2048; the table in
    # registers at k <= 2, in shared memory above) and the rolled
    # shared-memory instance past N = 2048, at every state depth and early
    # exit, ragged B, against the plain dense machine on the host and the
    # packed kernel.  Full sorts past N = 256 take rows with 61 distinct
    # values: the plain machine costs milliseconds a search on the host
    for n in (100, 256, 500, 1000, 2000, 4096):
        for k in (0, 1, 2, 8):
            for stop in (1, 16, None):
                x = _rows("uniform" if k % 2 else "normal", 3, n, 31 + k)
                if stop is None and n > 256:
                    x %= 61
                xt = torch.from_numpy(x).to(dev)
                dense = ops.colskip_sort_batched(xt, 32, k, stop_after=stop,
                                                 packed=False)
                packed = ops.colskip_sort_batched(xt, 32, k, stop_after=stop)
                plain_dense = ref.sort_ref(torch.from_numpy(x), 32, k, stop,
                                           packed=False)
                torch.cuda.synchronize()
                what = f"(3, {n}) k={k} stop={stop}"
                worst["colskip_dense"] = max(
                    worst["colskip_dense"],
                    _hold(f"dense colskip kernel != plain dense at {what}",
                          dense, plain_dense),
                    _hold(f"dense colskip kernel != packed kernel at {what}",
                          dense, packed))
        print(f"dense colskip kernel == plain dense == packed kernel: (3, {n}) "
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
    cases = [(8, 128, 8), (8, 4096, 64), (8, 16384, 100), (13, 1000, 5),
             (8, 600, 600), (3, 4096, 4096)]       # k = N
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
    # rows past the kernel's shared memory stream from device memory on
    # every pass (the sortable entry only: float32 rows stop at MAX_N)
    for b, n, k in ((1, 65536, 50), (3, 20000, 20000)):
        u = torch.from_numpy(rng.integers(0, 1 << 32, (b, n), dtype=np.uint64)
                             .astype(np.uint32)).to(dev)
        u[-1] = 7                              # a constant row
        got = ops.threshold_sortable(u, k)
        want = ref.threshold_ref(u.cpu(), k)
        torch.cuda.synchronize()
        errs = [_max_err(g, w) for g, w in zip(got, want)]
        worst = max(worst, *errs)
        if any(errs):
            _fail(f"radix kernel != plain at ({b}, {n}) k={k}, streamed: max "
                  f"errors (thresh, visited) {errs}")
        print(f"radix kernel == plain version: ({b}, {n}) k={k}, sortable "
              f"entry, streamed (rows past {ops.smem_n()} words)")
    return worst


def hold_mesh(torch, np) -> dict:
    """The mesh kernels (both carriers) against the local packed kernel
    (exact), the plain mesh of their carrier on the host (widths up to 256:
    on the card the plain machine is launch-bound) and the numpy hardware
    model; each row's exchange rounds within the reference's static
    account.  Returns the worst error per carrier."""
    from repro_torch.core.colskip import colskip_sort
    from repro_torch.dist.bankmesh import collective_rounds
    from repro_torch.kernels.colskip import ops, ref
    dev = torch.device("cuda")
    worst = {"colskip_mesh": 0, "colskip_mesh_dense": 0}
    cases = []
    for banks in (2, 4, 8):
        for fuse in (1, 2, 4):
            cases += [(banks, fuse, 8, banks * 32, 2, None, "mapreduce"),
                      (banks, fuse, 8, banks * 2048, 2, None, "uniform"),
                      (banks, fuse, 3, banks * 2048, 8, 16, "normal"),
                      (banks, fuse, 5, banks * 512, 0, 1, "kruskal")]
        cases += [(banks, 2, 8, 256, k, stop, data)
                  for k, stop, data in ((0, None, "clustered"),
                                        (8, 16, "uniform"),
                                        (2, 1, "mapreduce"))]
        cases.append((banks, 4, 2, banks * 4096, 2, 16, "uniform"))  # smem
    cases = [(packed,) + c for c in cases for packed in (True, False)]
    for packed, banks, fuse, b, n, k, stop, data in cases:
        x = _rows(data, b, n, 17 * banks + fuse + k)
        xt = torch.from_numpy(x).to(dev)
        got = ops.colskip_sort_mesh_batched(xt, banks, 32, k, stop_after=stop,
                                            packed=packed, fuse=fuse,
                                            return_rounds=True)
        local = ops.colskip_sort_batched(xt, 32, k, stop_after=stop)
        torch.cuda.synchronize()
        name = "colskip_mesh" if packed else "colskip_mesh_dense"
        what = (f"{'packed' if packed else 'dense'} D={banks} fuse={fuse} "
                f"({b}, {n}) k={k} stop={stop} {data}")
        worst[name] = max(worst[name], _hold(
            f"mesh kernel != local kernel at {what}", got[:4], local))
        s = n if stop is None else min(stop, n)
        rounds, acct = int(got[4].max()), collective_rounds(32, s, fuse)
        if not 0 < rounds <= acct["rounds"]:
            _fail(f"mesh kernel made {rounds} rounds at {what}, static "
                  f"account {acct['rounds']}")
        if n <= 256:
            worst[name] = max(worst[name], _hold(
                f"mesh kernel != plain mesh at {what}", got[:4],
                ref.sort_mesh_ref(torch.from_numpy(x), banks, 32, k, s,
                                  packed=packed, fuse=fuse)))
        if data == "uniform" and stop is None:
            out = [t.cpu() for t in got[:4]]
            _hold_model(np, colskip_sort, x[0], 32, k, None, 0, out,
                        f"mesh kernel at {what}")
    print(f"colskip mesh kernels (packed, dense) == local packed kernel (and "
          f"plain mesh at N <= 256, numpy model on uniform rows): "
          f"{len(cases)} cases, D in {{2, 4, 8}}, fuse in {{1, 2, 4}}, k in "
          "{0, 2, 8}, stop_after in {1, 16, N}, N up to D x 4096; rounds "
          "within the static account")
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


def serve_mesh(torch, dense: bool = False) -> dict:
    """The smoke workload through ``--mesh --fuse 2`` (``--dense``: on the
    dense carrier): the mesh kernel's launches (and the local fallback's),
    the collectives section and the kernel's own rounds beside the static
    account."""
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.launch import sortserve
    from repro_torch.sortserve.backends import ShardedColskipBackend
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    label = "dense mesh" if dense else "mesh"
    telem_path = out / f"{label.replace(' ', '_')}_telemetry.json"
    colskip_ops.reset_launches()
    radix_ops.reset_launches()
    t0 = time.perf_counter()
    rc = sortserve.main(["--smoke", "--device", "cuda", "--mesh", "--fuse",
                         "2", "--requests", "200", "--min_len", "64",
                         "--max_len", "4096", "--seed", "0",
                         "--sim_width_cap", "2048", "--json", str(telem_path)]
                        + (["--dense"] if dense else []))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel = "colskip_mesh_dense" if dense else "colskip_mesh"
    launches = {kernel: (colskip_ops.launches_mesh_dense if dense
                         else colskip_ops.launches_mesh),
                "one-bank fallback": (colskip_ops.launches_dense if dense
                                      else colskip_ops.launches),
                "radix_threshold": radix_ops.launches}
    rounds = {"kernel": ShardedColskipBackend.kernel_rounds,
              "static": ShardedColskipBackend.static_rounds}
    if rc != 0:
        _fail(f"sortserve --mesh smoke ({label}) returned {rc}")
    telem = json.loads(telem_path.read_text())
    print(f"{label} smoke took {wall:.3f} s wall for {telem['requests']} "
          "requests on cuda")
    print(f"{label} smoke tiles and wall seconds per backend: " + json.dumps(
        {k: {"tiles": v["tiles"], "wall_s": v["wall_s"]}
         for k, v in sorted(telem["per_backend"].items())}))
    print(f"kernel launches in the {label} smoke: {json.dumps(launches)}")
    print(f"{label} smoke collectives (the reference's static account): "
          f"{json.dumps(telem['collectives'])}")
    print(f"{label} kernel's own exchange rounds (slowest row of each tile, "
          f"summed): {rounds['kernel']} of a static account of "
          f"{rounds['static']}")
    if launches[kernel] <= 0 or launches["radix_threshold"] <= 0:
        _fail(f"the {label} smoke launched {launches}")
    if dense:
        return launches
    # the double buffer on the card: six whole-pool tiles arrive at vt 0,
    # so each admit after the first stages its successor's copy on the
    # side stream and the successor runs on it (the reference's check)
    import numpy as np
    from repro_torch.sortserve import EngineConfig, SortServeEngine
    from repro_torch.sortserve.batcher import Tile
    eng = SortServeEngine(EngineConfig(
        backends=("colskip_mesh",), mesh=True, mesh_hosts=2, fuse=2,
        tile_rows=4, min_bucket=8, banks=4, bank_width=64, bank_rows=4,
        sim_width_cap=4096, cache_size=0, device="cuda"))
    rng = np.random.default_rng(5)
    tiles = [Tile(op="sort", data=rng.integers(0, 1 << 32, (4, 256),
                                               dtype=np.uint64)
                  .astype(np.uint32), k=None, entries=[], pad_rows=4)
             for _ in range(6)]
    results = {}
    eng.scheduler.feed(tiles, eng._execute, at=0.0,
                       sink=lambda tile, res, exc: results.update(
                           {id(tile): (res, exc)}))
    eng.scheduler.pump()
    coll = eng.telemetry()["collectives"]
    print(f"double buffer on the card (6 tiles at vt 0): staged "
          f"{coll['prefetch_staged']}, hits {coll['prefetch_hits']}")
    for tile in tiles:
        res, exc = results[id(tile)]
        if exc is not None or not np.array_equal(
                res.values, np.sort(tile.data, -1)):
            _fail(f"a prefetched mesh tile came back wrong: {exc}")
    if (coll["prefetch_staged"], coll["prefetch_hits"]) != (4, 4):
        _fail(f"double buffer staged/hit {coll}")
    if not 0 < rounds["kernel"] <= rounds["static"] == \
            telem["collectives"]["rounds"]:
        _fail(f"mesh kernel rounds {rounds} against the collectives section "
              f"{telem['collectives']}")
    return launches


def serve_fleet(torch) -> None:
    """Two replicas with a rolling restart and a warm-state artifact: the
    first run writes the artifact, the second reloads it."""
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.launch import sortserve
    from repro_torch.sortserve import load_warm_state
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    warm = out / "fleet_warm_state.json"
    warm.unlink(missing_ok=True)
    for run, requests in (("first", "200"), ("second", "80")):
        telem_path = out / f"fleet_{run}.json"
        colskip_ops.reset_launches()
        radix_ops.reset_launches()
        t0 = time.perf_counter()
        rc = sortserve.main(["--smoke", "--device", "cuda", "--replicas", "2",
                             "--rolling-restart", "--warm-state", str(warm),
                             "--requests", requests, "--min_len", "64",
                             "--max_len", "4096", "--seed", "0",
                             "--sim_width_cap", "2048",
                             "--json", str(telem_path)])
        torch.cuda.synchronize()
        fleet = json.loads(telem_path.read_text())
        launches = {"colskip": colskip_ops.launches,
                    "radix_threshold": radix_ops.launches}
        print(f"fleet smoke ({run} run, {requests} requests): "
              f"{time.perf_counter() - t0:.3f} s wall, shed={fleet['shed']} "
              f"restarts={fleet['restarts']} failed={fleet['failed']}, "
              f"kernel launches {json.dumps(launches)}")
        if rc != 0 or fleet["shed"] or fleet["restarts"] != 2 \
                or fleet["failed"]:
            _fail(f"fleet smoke ({run} run) returned {rc}: {fleet}")
        if min(launches.values()) <= 0:
            _fail(f"the fleet smoke launched {launches}")
        art = load_warm_state(str(warm))
        print(f"warm-state artifact after the {run} run: "
              f"{len(art['priors'])} priors, "
              f"{sum(len(m) for m in art['menus'].values())} signatures, "
              f"{len(art['calibration'])} calibration rows")


# Rows whose PASS is a correctness predicate of the output (sorted values,
# threshold or index equality, carrier parity); every other PASS/MISS is a
# performance or paper band.
CORRECTNESS_ROWS = ("kernel/", "serving/", "streaming/session_",
                    "streaming/degraded_", "streaming/fleet_steady",
                    "streaming/fleet_rolling")


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
                "colskip_mesh": colskip_ops.launches_mesh,
                "radix_threshold": radix_ops.launches,
                "bitonic": bitonic_ops.launches}
    doc = json.loads(out.read_text())
    print(f"benchmark suites took {wall:.3f} s wall on cuda: "
          f"{len(doc['rows'])} rows, {doc['band_misses']} band misses, "
          f"{len(doc['errors'])} suite errors")
    print(f"kernel launches in the benchmark run: {json.dumps(launches)}")
    if rc != 0 or doc["errors"]:
        _fail(f"benchmark suites failed: {doc['errors']}")
    suites = {r["name"].split("/")[0].split("_")[0] for r in doc["rows"]}
    if len(bench_run.SUITES) != 10 or "distserve" not in suites:
        _fail(f"expected the ten suites, got {bench_run.SUITES}")
    for row in doc["rows"]:
        if row["name"] in BEFORE_ROWS_US:
            print(f"{row['name']}: {row['us_per_call']:.1f} us (before: "
                  f"{BEFORE_ROWS_US[row['name']]} us) {row['derived']}")
        if row["name"] == "packed/colskip_sim_1024/speedup":
            print(f"packed_speedup band (>= 1.5): {row['derived']}")
        if row["name"].startswith(("distserve_", "streaming/session_",
                                   "streaming/fleet_")):
            print(f"{row['name']}: {row['us_per_call']:.1f} us "
                  f"{row['derived']}")
        if row["name"].startswith("distserve_") and \
                not row["derived"].endswith("cycle_parity=ok"):
            _fail(f"distserve cycle parity broken: {row['name']} "
                  f"{row['derived']}")
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


def measure_mesh(torch, np, mesh_launches: int, err: int,
                 packed: bool = True) -> dict:
    """The carrier's mesh kernel row: (8, 2048) uniform at D in {2, 4, 8} x
    fuse in {1, 2, 4} beside the carrier's local kernel on the same tile;
    the row's own numbers at D = 4, fuse = 2 (the ``--mesh --fuse 2``
    smoke's)."""
    from repro_torch.dist.bankmesh import collective_rounds
    from repro_torch.kernels.colskip import ops, ref
    dev = torch.device("cuda")
    b, n, w, k = 8, 2048, 32, 2
    x = torch.from_numpy(_rows("uniform", b, n, 5)).to(dev)
    searches = max(_searches(x))
    name = "colskip_mesh" if packed else "colskip_mesh_dense"
    local_ms = _time_ms(lambda: ops.colskip_sort_batched(
        x, w, k, packed=packed), 10)
    table = []
    for banks in (2, 4, 8):
        ops.mesh_chain(1000, banks)
        chain_ms = _time_ms(lambda: ops.mesh_chain(MESH_ROUNDS, banks), 3)
        round_ns = chain_ms * 1e6 / MESH_ROUNDS
        for fuse in (1, 2, 4):
            out = ops.colskip_sort_mesh_batched(x, banks, w, k, fuse=fuse,
                                                packed=packed,
                                                return_rounds=True)
            ms = _time_ms(lambda: ops.colskip_sort_mesh_batched(
                x, banks, w, k, fuse=fuse, packed=packed), 5)
            rounds = int(out[4].max())
            table.append({"banks": banks, "fuse": fuse, "ms": ms,
                          "rounds_max_row": rounds,
                          "static_rounds": collective_rounds(w, n, fuse)[
                              "rounds"],
                          "round_ns": round_ns,
                          "bound_ms": searches * round_ns * 1e-6,
                          "chain_ms": rounds * round_ns * 1e-6})
            print(f"{name} D={banks} fuse={fuse}: {ms:.4f} ms at "
                  f"({b}, {n}) uniform (the carrier's local kernel "
                  f"{local_ms:.4f} ms); {rounds} exchange rounds on the "
                  f"slowest row "
                  f"(static account {table[-1]['static_rounds']}); one "
                  f"cross-bank round {round_ns:.1f} ns")
    main = next(r for r in table if r["banks"] == 4 and r["fuse"] == 2)
    plain_ms = _host_ms(lambda: ref.sort_mesh_ref(x.cpu(), 4, w, k, fuse=2,
                                                  packed=packed))
    return _row(name,
                "src/repro_torch/kernels/colskip/csrc/colskip_mesh.cu",
                "src/repro/dist/bankmesh.py:126 (not a Pallas kernel)",
                mesh_launches, err, main["ms"], plain_ms,
                b * n * 4 + b * n * 8 + b * 12, main["bound_ms"], None,
                shape=f"({b}, {n}) uint32 w={w} k={k} uniform, D=4 banks, "
                      "fuse=2", plain_device="cpu", local_kernel_ms=local_ms,
                searches_max_row=searches, round_ns=main["round_ns"],
                rounds_max_row=main["rounds_max_row"],
                static_rounds=main["static_rounds"],
                rounds_chain_ms=main["chain_ms"], table=table)


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
    # word operations (compare, and, shift, mask, add per element per
    # pass) are printed beside it, not taken as the bound.  The kernel's
    # passes: the OR/AND pass, then one a digit of the visited planes.
    # The launch floor: an empty kernel launched as one tile, timed alike
    digit = radix_ops.digit_bits()
    passes = 1 + -(-int(visited.max()) // digit)
    r_bytes = b * n * 4 + b * 8
    # back to back the calls are bound by the host's enqueue (some tens of
    # us a call), so each time is also taken on the device alone: calls
    # queued behind a busy kernel run back to back on the card
    ms = _time_ms(lambda: radix_ops.threshold_sortable(u, k), 50)
    floor_ms = _time_ms(radix_ops.empty_launch, 50)
    plain_ms = _time_ms(lambda: radix_ref.threshold_ref(u, k), 3)
    keys = as_words(u)
    lib_ms = _time_ms(lambda: torch.topk(keys, k, dim=-1), 50)
    busy = lambda: colskip_ops.vote_chain(VOTE_ROUNDS)      # noqa: E731
    device_ms, enqueue_ms = _queued_ms(
        torch, lambda: radix_ops.threshold_sortable(u, k), 50, busy)
    floor_device_ms, _ = _queued_ms(torch, radix_ops.empty_launch, 50, busy)
    lib_device_ms, _ = _queued_ms(
        torch, lambda: torch.topk(keys, k, dim=-1), 50, busy)
    rows.append(_row("radix_threshold",
                     "src/repro_torch/kernels/radix_topk/csrc/radix_threshold.cu",
                     "src/repro/kernels/radix_topk/kernel.py:48",
                     launches["radix_threshold"], errs["radix_threshold"], ms,
                     plain_ms, r_bytes, None, lib_ms,
                     shape=f"({b}, {n}) sortable uint32 k={k}",
                     visited=int(visited.max()), digit_bits=digit,
                     kernel_passes=passes, launch_floor_ms=floor_ms,
                     device_ms=device_ms, host_enqueue_ms=enqueue_ms,
                     launch_floor_device_ms=floor_device_ms,
                     library_device_ms=lib_device_ms,
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
            "library_ms": library_ms,
            "bytes": nbytes, "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            **extra}


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
    mesh_spills = [line.strip() for line in
                   logs.get("colskip_mesh", "").splitlines()
                   if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]
    print(f"colskip_mesh instances that spill: {mesh_spills or 'none'}")
    spills = register_path_spills(logs.get("colskip", ""))
    print(f"colskip register-path spills (stores, loads): "
          f"{json.dumps(spills)}")
    for kernel in ("colskip_sort_kernel", "colskip_dense_kernel"):
        if not any(kernel in name for name in spills):
            _fail(f"no register-path instance of {kernel} in the colskip "
                  "ptxas report")

    # 3-4. hold each kernel against its plain version (and the hw model)
    t0 = time.perf_counter()
    errs = {**hold_colskip(torch, np),
            "radix_threshold": hold_radix(torch, np),
            "bitonic": hold_bitonic(torch, np)}
    print(f"phases 3-4 (holds) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs.update(hold_mesh(torch, np))
    print(f"phase 4 (mesh holds) took {time.perf_counter() - t0:.1f} s")

    # 5. the main path: the sortserve smoke on the card, then through the
    # mesh bank pool, then a two-replica fleet
    launches = serve(torch)
    t0 = time.perf_counter()
    mesh_launches = {**serve_mesh(torch), **serve_mesh(torch, dense=True)}
    serve_fleet(torch)
    print(f"phase 5 (mesh and fleet smokes) took "
          f"{time.perf_counter() - t0:.1f} s")

    # 6. the benchmark path: the port's eight suites on the card
    bench_launches = bench(torch)

    # 7. timings at the paths' shapes
    t0 = time.perf_counter()
    rows = measure(torch, np, launches, bench_launches, errs)
    for packed, name in ((True, "colskip_mesh"),
                         (False, "colskip_mesh_dense")):
        rows.append(measure_mesh(torch, np, mesh_launches[name], errs[name],
                                 packed))
    print(f"phase 7 (timings) took {time.perf_counter() - t0:.1f} s")
    for r in rows:
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        before = (f"{BEFORE_MS[r['name']]} ms" if r["name"] in BEFORE_MS
                  else "none, new kernel")
        print(f"{r['name']}: {r['ms']:.4f} ms/launch at {r['shape']} "
              f"(before: {before}; plain "
              f"{r['plain_ms']:.3f} ms, library {lib}, bound {r['bound_ms']:.6f} ms by "
              f"{r['bound_by']}), {r['launches']} launches on its path")
        if r["name"] == "radix_threshold":
            print(f"radix_threshold: on the device {r['device_ms']:.5f} ms "
                  f"(host enqueue {r['host_enqueue_ms']:.5f} ms a call; "
                  f"torch.topk {r['library_device_ms']:.5f} ms); launch "
                  f"floor {r['launch_floor_ms']:.5f} ms back to back, "
                  f"{r['launch_floor_device_ms']:.5f} ms on the device (an "
                  f"empty kernel launched as one tile); "
                  f"{r['kernel_passes']} passes of the kernel "
                  f"({r['digit_bits']}-plane digits) for {r['visited']} "
                  "visited planes")
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
