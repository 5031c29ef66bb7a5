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
     and on the streamed instance ((1, 65536), (3, 20000), sortable); its
     narrow instance (rows of at most 1,024 words, a warp a row) on both
     entries, the threshold and the fused top-k (values and indices),
     each on float32 values and sortable words, at N in {1, 7, 32, 40,
     64, 640, 1024}, k in {1, 8, N}, with ties, +-0.0 and -inf, and at
     the train step's router rows (8192, 40), k = 8, every launch on the
     narrow instance; the block instance's fused top-k entry
     (``SELECT_CASES``: float32 and sortable, kmin, plane reads, the
     packed buffer; streamed to (1, 65536) k = 40,000) and the banked
     entry with the payload manager pass at the six vocab rows
     (``VOCAB_ROWS``), each launch on the instance the code implies;
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
     reset just before and read just after: each must be above 0, and
     every radix tile exactly one launch of the fused top-k entry.  Then
     the same workload with ``--mesh --fuse 2`` and with ``--mesh --dense
     --fuse 2`` (the carrier's mesh kernel's launch count must be above 0;
     the local fallback's, the ``collectives`` section and the kernel's
     own rounds beside the static account are printed), the double buffer
     on the card (six tiles at once: 4 copies staged on the side stream, 4
     hits), and a ``--replicas 2 --rolling-restart --warm-state`` fleet (0
     sheds, 2 restarts), run twice so the second run reloads the artifact
     the first wrote;
  6. the benchmark path: run the port's eleven benchmark suites
     (``repro_torch.benchmarks.run --out``) on ``cuda`` with every launch
     count reset just before and read just after: no suite may fail, no
     correctness predicate may MISS (sorted output, threshold and index
     equality, CR parity, ``distserve``'s ``cycle_parity=ok``, every
     ``hw/`` row: fused digests equal at fuse 1, 2, 4 with ``round_cr >=
     1.5``, and a warm process with 0 persistent misses), and every
     kernel must have launched (the mesh kernel also in ``hw_bench``'s
     fused worker, whose count comes back in its rows); a MISS of a performance or paper band is
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
  8. the model-serving path (``repro_torch.models``, ``repro_torch.serve``):
     the ten archs at smoke size in float32 with TF32 off, one seeded CPU
     model and its copy on the card, prefill and 3 decode steps' logits
     and every leaf of the state or cache on cuda against cpu
     (``SMOKE_TOL``), every router call's expert ids exact on the same
     probabilities, and for the families that warm up token by token
     (ssm, hybrid, encdec) the whole prompt through ``decode_step`` on
     the card against ``prefill``'s last logits; then ``serve.generate``
     at full width and depth (``MODEL_RUNS``, bf16, weights from a seeded
     generator, top_p 0.9): granite-moe-3b-a800m (B = 4, prompt 128, 32
     new tokens, top_k 16), gemma3-4b (B = 1, prompt 1536, past its 1024
     window, 16 new, top_k 64), hymba-1.5b (B = 4, prompt 64, 32 new,
     top_k 16), rwkv6-1.6b (B = 8, 64, 32, 16), whisper-tiny (B = 4, 32,
     32, 16, on seeded normal frames) and qwen2-vl-7b (B = 2, 256, 16,
     64): with every launch count reset just before and read just after,
     the radix launches equal the count the code implies, and every
     router call and manager pass took the narrow instance's fused top-k
     entry (one launch); every ``radix_topk`` call of the run (the MoE
     router's and the sampler's, recorded by a wrapper this script
     installs around both kernel entries) replayed through the kernel's
     plain versions on the card, values and indices exact; a
     repeat run with the same generator gives the same tokens; every
     token is below ``vocab``; ``greedy`` equals ``torch.argmax`` on every
     step's logits.  Then the prompt's ms (prefill, or the whole warm-up),
     decode ms a step, tokens/s and peak memory, a profiled run's split
     of a decode step (router and sampler radix, experts, attention, the
     recurrences; device and host) and the attention kernels
     ``F.scaled_dot_product_attention`` chose; qwen2-vl's prefill on 256
     patch embeddings with M-RoPE positions of a 16 x 16 grid (finite,
     and unlike the 1-D positions' logits); and the radix kernel's rows at
     the path's shapes (the router's (512, 40) and (4, 40), the sampler's
     vocab rows of 2 to 16 banks), each beside its bound, launch floor,
     plain version, ``torch.topk`` and the whole call, with the entry and
     the instance of each launch;
  9. the training path (``repro_torch.train``, ``ckpt``, ``data``,
     ``launch.train``): the ten archs at smoke size in float32 with TF32
     off, one seeded CPU train state and its copy on the card, one
     ``make_train_step`` each: loss, grad norm and every grad leaf on cuda
     against cpu (``SMOKE_TOL``, ``TRAIN_GRAD_REL``), every router call
     (forward and remat recompute) with expert ids exact on the same
     probabilities; on the card, microbatches 2 against 1 (hymba: every
     grad leaf within ``MICROBATCH_GRAD_REL`` of its largest value, the
     params within 2e-5), a resume from a checkpoint against 4 steps never stopped
     (rwkv6, within 1e-6), and that checkpoint restored on the CPU, equal.
     Then ``repro_torch.launch.train.main`` at full width for
     granite-moe-3b-a800m (bf16, B = 2, S = 4,096, 4 steps, no
     checkpoint): with every launch count reset just before and read just
     after, the radix launches equal the count the code implies (2 x 32 a
     step: each router and its recompute), all on the narrow instance;
     the first step's router calls
     replayed through the kernel's plain version on the card (values and
     indices exact), the recompute's ids equal to the forward's; finite
     losses and grad norms; weights moved by step 1.  Then the step's ms
     (host clock, each step synchronised, median after the first),
     tokens/s, peak memory beside the train state's bytes, a profiled
     step's split (forward, backward and optimizer spans; router radix,
     experts and attention, device and host; idle share), and the radix
     row at the training router's shape (8192, 40), k = 8;
 10. distribution (``repro_torch.dist``, ``core/distsort``,
     ``launch/mesh``): 4 ranks spawned on the card, joined by ``gloo``
     (NCCL refuses two ranks on one card), every collective staged
     through the host; any rank's failure fails the run.  (a) The §IV
     selection: ``kth_largest_sharded``, ``topk_mask_sharded`` (k = 64
     and 1 %) and ``global_min_sharded`` on sortable rows (8, 4 x 16384)
     and on one layer's expert bank of granite's gradient (48 x 1536 x
     512 float32), uniform, heavy duplicates and all equal, each exact
     against one rank's plain function on the whole tensor, with ms and
     collectives a call.  (b) The slice's path: granite-moe-3b-a800m at
     full width, expert-parallel on a (data 2, model 2) mesh, each rank
     drawing the weights from one seed and keeping its 24 of the 48
     padded experts, phase 8's ``generate`` on its 2 of the 4 prompts:
     with every launch count reset just before and read just after, the
     radix launches a rank equal the count the code implies (1,120),
     every radix call replayed through the plain version on the card, a
     repeat run, the model ranks of a data row sampling the same tokens,
     the first MoE layer on a seeded input against one rank's (ids
     exact, ``EP_LAYER_TOL``) and the prefill's last logits within
     ``EP_LOGIT_REL`` of one rank's on the data row's prompts and the same
     weights; prompt and decode ms, tokens/s, peak memory and
     the host time of the decode step's 32 psums.  (c) whisper-tiny at
     full width, ``make_dp_train_step`` at 1 % for 3 steps (finite
     losses, a residual), ratio 1.0 against the plain ``pmean`` step
     (``DP_EQ_TOL`` on the f32 masters, with the math attention backend),
     and the plain step's grads on a dense arch at smoke size against one
     replica's on the whole batch (``DP_ONE_REL``).  (d)
     ``make_pipelined_fn`` over the 4 ranks against its stages one after
     another (``PIPE_TOL``).  (e) One rank on ``nccl``: a DP step, the EP
     layer and the collectives on their dtypes.  Then the radix rows at
     the EP router's per-rank shapes;
 11. the sort-serving hardware path: a profile from
     ``repro_torch.benchmarks.hw_tune`` into a fresh directory, then
     ``launch/sortserve.py --smoke --mesh --fuse 2 --compile-cache D
     --hw-profile P`` twice, each in a fresh process (0 oracle mismatches;
     the first builds libraries, persistent misses above 0; the second
     builds none, 0 misses and hits above 0; both walls printed); the five
     example twins (``examples/torch``) on ``cuda`` at once, each exiting
     0 with its check printed; the dry-run of granite-moe-3b-a800m
     ``train_4k`` on ``meta`` (status ok), its roofline printed beside
     phase 9's step; and row 1e, the mesh kernel at ``hw_bench``'s shape
     ((1, 1024), D = 4, F in {1, 2, 4}) against the plain mesh (exact),
     with its own rounds and bound;
 12. print ``{"ok": true, "device": {...}}`` as the last line.

Exact integer outputs: every tolerance is equality (``max_abs_err`` 0).
"""

from __future__ import annotations

import contextlib
import dataclasses
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


def mesh_spills(log: str) -> dict:
    """The mesh kernel instances that spill in an ``-Xptxas -v`` log: the
    kernel and its template arguments (mangled) -> the spill line."""
    lines = log.splitlines()
    out = {}
    for i, line in enumerate(lines[:-1]):
        m = re.search(r"Function properties for \S*?\d(colskip_mesh"
                      r"(?:_dense)?_kernel)I(\w+?)EEv", line)
        if m and re.search(r"[1-9]\d* bytes spill", lines[i + 1]):
            out[f"{m.group(1)}<{m.group(2)}>"] = lines[i + 1].strip()
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
    # the narrow instance: the threshold entry and the fused top-k entry,
    # each on float32 values and on sortable words, at the CPU emulation's
    # shapes and the train step's router rows, against their plain versions
    # on the card (thresholds, visited, values bit for bit, indices)
    if ops._lib().radix_narrow_n() != ops.NARROW_N:
        _fail(f"radix_narrow_n() != ops.NARROW_N = {ops.NARROW_N}")
    narrow = [(13, 1, 1, "normal"), (3, 7, 1, "dupes"), (13, 7, 7, "signed"),
              (13, 32, 8, "dupes"), (3, 32, 32, "normal"),
              (13, 40, 8, "dupes"), (9, 40, 1, "signed"),
              (13, 40, 40, "normal"), (3, 64, 8, "signed"),
              (13, 64, 64, "dupes"), (4, 64, 16, "normal"),
              (3, 640, 8, "dupes"), (13, 640, 640, "signed"),
              (2, 640, 64, "normal"), (3, 1024, 1, "signed"),
              (1, 1024, 64, "normal"), (9, 1024, 1024, "dupes"),
              (8192, 40, 8, "router")]
    for b, n, k, data in narrow:
        x = (rng.normal(size=(b, n)) * 100).astype(np.float32)
        if data == "dupes":                    # many ties at the threshold
            x = np.round(x / 60).astype(np.float32) * np.float32(60)
        if data == "signed":
            pick = rng.integers(0, 3, (b, n))
            x = np.where(pick == 0, np.float32(0.0),
                         np.where(pick == 1, np.float32(-0.0), x))
            x[:, ::5] = -np.inf
        if data == "router":                   # softmax rows, ties among them
            x = torch.softmax(torch.from_numpy(x / 100), -1).numpy()
            x[::7, :4] = x[::7, 4:8]
        else:
            if b > 2:
                x[1] = np.float32(-2.5)        # a constant row
            if b > 8:
                x[8:] = np.float32(3.0)        # a constant ragged tile
        xf = torch.from_numpy(x).to(dev)
        u = to_uint32(to_sortable_uint(xf))
        before = ops.instance_launches["narrow"]
        got = [ops.threshold_f32(xf, k), ops.threshold_sortable(u, k),
               ops.fused_topk(xf, k), ops.fused_topk(u, k)]
        want_t = ref.threshold_ref(to_sortable_uint(xf), k)
        want = [want_t, want_t, ops._plain_topk(xf, k),
                ops._plain_topk(u, k)]
        torch.cuda.synchronize()
        if ops.instance_launches["narrow"] - before != 4:
            _fail(f"radix at ({b}, {n}): not every launch took the narrow "
                  f"instance: {ops.instance_launches}")
        for what, g, w in zip(("threshold float32", "threshold sortable",
                               "top-k float32", "top-k sortable"), got, want):
            g, w = ([t.view(torch.int32) if t.dtype == torch.float32 else t
                     for t in pair] for pair in (g, w))
            worst = max(worst, _hold(f"radix narrow instance != plain at "
                                     f"({b}, {n}) k={k} {data}, {what} "
                                     "entry", g, w))
    print(f"radix narrow instance == plain version, threshold and fused "
          f"top-k entries, float32 and sortable: "
          f"{[(b, n, k, d) for b, n, k, d in narrow]}")
    return max(worst, hold_radix_select(torch, np, rng))


# the fused top-k entry with the sort-serving options (kmin, plane reads,
# the packed buffer), held against its plain version: (B, N, k, data).
# Rows of at most 1,024 words take the narrow instance (the smoke's narrow
# tiles: 64 to 1,024 words), wider ones the block instance; rows past
# radix_smem_n() stream (sortable words only), and at k = 40,000 their
# slots outgrow shared memory and live in the output row
SELECT_CASES = ((13, 64, 64, "dupes"), (8, 300, 17, "dupes"),
                (8, 1024, 32, "normal"),
                (8, 4096, 64, "normal"), (8, 16384, 100, "normal"),
                (3, 4096, 4096, "normal"), (13, 1500, 37, "dupes"),
                (8, 4096, 32, "dupes"), (1, 65536, 50, "normal"),
                (3, 20000, 20000, "dupes"), (1, 65536, 40000, "normal"))
# the sampler's vocab rows (rows 2c to 2h): (B, V, k), banked at MAX_N
VOCAB_ROWS = ((4, 49408, 16), (1, 262144, 64), (4, 32256, 16),
              (8, 65536, 16), (4, 51968, 16), (2, 152064, 64))


def hold_radix_select(torch, np, rng) -> int:
    """The top-k entry on the narrow instance and the block instance, in
    shared memory and streamed: float32 values and sortable words, the
    complement (kmin) and each row's plane reads, the packed buffer of a
    sort-serving tile; the
    banked entry and the payload manager pass at the sampler's vocab rows,
    each launch on the instance the code implies.  Exact (values' bits,
    indices, reads)."""
    from repro_torch.core.bitmatrix import to_uint32
    from repro_torch.core.topk import to_sortable_uint
    from repro_torch.kernels.radix_topk import ops
    dev = torch.device("cuda")
    worst = 0

    def held(what, got, want):
        got, want = ([t.view(torch.int32) if t.dtype == torch.float32 else t
                      for t in (pair if isinstance(pair, tuple) else (pair,))]
                     for pair in (got, want))
        torch.cuda.synchronize()
        return _hold(f"radix fused top-k != plain at {what}", got, want)

    for b, n, k, data in SELECT_CASES:
        x = (rng.normal(size=(b, n)) * 100).astype(np.float32)
        if data == "dupes":                    # many ties at the threshold
            x = np.round(x / 60).astype(np.float32) * np.float32(60)
        x[min(1, b - 1)] = np.float32(-2.5)    # a constant row
        if b > 8:
            x[8:] = np.float32(3.0)            # a constant ragged tile
        xf = torch.from_numpy(x).to(dev)
        u = to_uint32(to_sortable_uint(xf))
        inst = ops.instance(n)
        runs = [(u, False), (u, True)] + ([(xf, False)] if n <= ops.MAX_N
                                          else [])
        for arr, kmin in runs:
            before = ops.instance_launches[inst]
            got = ops.fused_topk(arr, k, complement=kmin, reads=True)
            if ops.instance_launches[inst] != before + 1:
                _fail(f"radix fused top-k at ({b}, {n}) did not take one "
                      f"{inst} launch: {ops.instance_launches}")
            worst = max(worst, held(
                f"({b}, {n}) k={k} {data} {arr.dtype} kmin={kmin}", got,
                ops._plain_topk(arr, k, complement=kmin, reads=True)))
        # the sort-serving tile's packed buffer: values, indices, reads
        worst = max(worst, held(
            f"({b}, {n}) k={k} packed kmin", ops.fused_topk(
                u, k, complement=True, reads=True, packed=True),
            ops._plain_topk(u, k, complement=True, reads=True,
                            packed=True)))
    print(f"radix fused top-k entry (narrow and block instances, in shared "
          f"memory and streamed) == plain version: float32 and sortable, "
          f"kmin, plane reads, packed: {list(SELECT_CASES)}")
    for b, v, k in VOCAB_ROWS:
        x = torch.from_numpy(rng.normal(size=(b, v)).astype(np.float32)
                             ).to(dev)
        x[0, :64] = x[0, 20000:20064]          # ties across banks
        c, kb = -(-v // ops.MAX_N), min(k, ops.MAX_N)
        before = dict(ops.instance_launches)
        vb, ib = ops.fused_topk(x, kb, bank=ops.MAX_N)
        cand = (vb.view(b, c * kb), ib.view(b, c * kb))
        vals, idxs = ops.fused_topk(cand[0], k, payload=cand[1])
        want_b = ops._plain_topk(x, kb, bank=ops.MAX_N)
        worst = max(worst, held(f"({b}, {v}) k={kb} banked", (vb, ib),
                                want_b))
        worst = max(worst, held(
            f"({b}, {v}) k={k} manager pass with payload", (vals, idxs),
            ops._plain_topk(want_b[0].view(b, c * kb), k,
                            payload=want_b[1].view(b, c * kb))))
        manager = ops.instance(c * kb)
        moved = {i: ops.instance_launches[i] - before[i]
                 for i in before}
        if moved != {i: (i == "block") + (i == manager) for i in before}:
            _fail(f"radix banked call at ({b}, {v}) launched {moved}")
        want = torch.sort(to_sortable_uint(x), dim=-1, descending=True,
                          stable=True).indices[:, :k]
        if not torch.equal(idxs.long(), want):
            _fail(f"radix banked call at ({b}, {v}) k={k} != a stable sort")
    print(f"radix banked entry + payload manager pass == plain version and "
          f"a stable sort's first k at the vocab rows {list(VOCAB_ROWS)}")
    return worst


# fuse values held in phase 4 beside 1, 2 and 4: a ragged top block (3, 5)
# and a pattern set of 8 words (8); phase 7 times these with 6 and 7
MESH_NEW_FUSES = (3, 5, 8)


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
        # fuse 3 and 5 (a ragged top block) and 8 (a pattern set of 8
        # words): lighter shapes, the full sorts at D x 256
        for fuse in MESH_NEW_FUSES:
            cases += [(banks, fuse, 8, banks * 32, 2, None, "mapreduce"),
                      (banks, fuse, 4, banks * 256, 1, None, "uniform"),
                      (banks, fuse, 3, banks * 2048, 8, 16, "normal"),
                      (banks, fuse, 2, banks * 4096, 0, 1, "kruskal")]
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
        # the plain mesh on the host where it is quick (its speculative
        # tree grows with 2^fuse)
        if n <= 256 and (fuse <= 4 or s <= 64):
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
          f"{len(cases)} cases, D in {{2, 4, 8}}, fuse in "
          f"{sorted((1, 2, 4) + MESH_NEW_FUSES)}, k in {{0, 1, 2, 8}}, "
          "stop_after in {1, 16, N}, N up to D x 4096; rounds within the "
          "static account")
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
    # the radix library's launches: every tile one launch of the fused
    # top-k entry, on the narrow instance (tiles of at most NARROW_N
    # words) or the block instance
    launches = {"colskip": colskip_ops.launches,
                "radix_narrow_topk": radix_ops.instance_launches["narrow"],
                "radix_block_topk": radix_ops.instance_launches["block"]}
    instances = dict(radix_ops.instance_launches)
    entries = dict(radix_ops.entry_launches)
    if rc != 0:
        _fail(f"sortserve smoke returned {rc}")
    telem = json.loads(telem_path.read_text())
    if telem["verify_failures"]:
        _fail(f"{telem['verify_failures']} verify failures")
    tiles = telem["per_backend"]["radix_topk"]["tiles"]
    if radix_ops.launches != tiles or entries["topk"] != tiles:
        _fail(f"{tiles} radix tiles took {radix_ops.launches} launches "
              f"({entries} by entry): each tile must be one launch of the "
              "fused top-k entry")
    print(f"sortserve.main took {wall:.3f} s wall for {telem['requests']} "
          f"requests on cuda (its serving time, printed above, plus the "
          f"oracle check, the telemetry dump and printing)")
    print("tiles and wall seconds per backend: " + json.dumps(
        {k: {"tiles": v["tiles"], "wall_s": v["wall_s"]}
         for k, v in sorted(telem["per_backend"].items())}))
    print(f"kernel launches in the smoke: {json.dumps(launches)}; radix "
          f"by instance (tiles of at most {radix_ops.NARROW_N} words take "
          f"the narrow one): {json.dumps(instances)}; by entry: "
          f"{json.dumps(entries)}; one fused launch a radix tile ({tiles} "
          "tiles)")
    for name, count in launches.items():
        if count <= 0:
            _fail(f"the smoke launched the {name} kernel {count} times")
    return launches


def serve_mesh(torch, dense: bool = False, fuse: int = 2) -> dict:
    """The smoke workload through ``--mesh --fuse F`` (``--dense``: on the
    dense carrier): the mesh kernel's launches (and the local fallback's),
    the collectives section and the kernel's own rounds beside the static
    account; at F = 2 on the packed carrier also the double buffer."""
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.launch import sortserve
    from repro_torch.sortserve.backends import ShardedColskipBackend
    out = ROOT / "build" / "chip_smoke"
    out.mkdir(parents=True, exist_ok=True)
    label = ("dense mesh" if dense else "mesh") + (
        "" if fuse == 2 else f" fuse {fuse}")
    telem_path = out / f"{label.replace(' ', '_')}_telemetry.json"
    colskip_ops.reset_launches()
    radix_ops.reset_launches()
    t0 = time.perf_counter()
    rc = sortserve.main(["--smoke", "--device", "cuda", "--mesh", "--fuse",
                         str(fuse), "--requests", "200", "--min_len", "64",
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
                "radix_fused_topk": radix_ops.entry_launches["topk"]}
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
    if launches[kernel] <= 0 or launches["radix_fused_topk"] <= 0:
        _fail(f"the {label} smoke launched {launches}")
    if telem["verify_failures"]:
        _fail(f"the {label} smoke: {telem['verify_failures']} mismatches")
    if not 0 < rounds["kernel"] <= rounds["static"]:
        _fail(f"{label} kernel rounds {rounds} over the static account")
    if dense or fuse != 2:
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
                    "radix_fused_topk": radix_ops.entry_launches["topk"]}
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
# threshold or index equality, carrier parity; hw: a response digest equal
# across fuse values, the static account's round CR, a build-free warm
# start); every other PASS/MISS is a performance or paper band.
CORRECTNESS_ROWS = ("kernel/", "serving/", "streaming/session_",
                    "streaming/degraded_", "streaming/fleet_steady",
                    "streaming/fleet_rolling", "hw/")


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
                "radix_threshold": radix_ops.entry_launches["threshold"],
                "radix_fused_topk": radix_ops.entry_launches["topk"],
                "bitonic": bitonic_ops.launches}
    doc = json.loads(out.read_text())
    print(f"benchmark suites took {wall:.3f} s wall on cuda: "
          f"{len(doc['rows'])} rows, {doc['band_misses']} band misses, "
          f"{len(doc['errors'])} suite errors")
    print(f"kernel launches in the benchmark run: {json.dumps(launches)}")
    if rc != 0 or doc["errors"]:
        _fail(f"benchmark suites failed: {doc['errors']}")
    suites = {r["name"].split("/")[0].split("_")[0] for r in doc["rows"]}
    if len(bench_run.SUITES) != 11 or not {"distserve", "hw"} <= suites:
        _fail(f"expected the eleven suites, got {bench_run.SUITES}")
    # the hw suite's fused worker runs in a process of its own: its mesh
    # kernel launches come back in its rows
    hw_rows = [r for r in doc["rows"] if r["name"].startswith("hw/")]
    launches["colskip_mesh_hw"] = sum(
        int(m.group(1)) for r in hw_rows
        for m in [re.search(r"mesh_launches=(\d+)", r["derived"])] if m)
    for row in hw_rows:
        print(f"{row['name']}: {row['us_per_call']:.1f} us "
              f"{row['derived']}")
    if len(hw_rows) != 5:
        _fail(f"expected 5 hw rows (3 fused, 2 persist), got {hw_rows}")
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
    fuse in {1, 2, 4}, and at D = 4 x fuse in {3, 5, 6, 7, 8}, beside the
    carrier's local kernel on the same tile; the row's own numbers at
    D = 4, fuse = 2 (the ``--mesh --fuse 2`` smoke's)."""
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
    # every other fuse at D = 4 (the packed row beside row 1c)
    chain_ms = _time_ms(lambda: ops.mesh_chain(MESH_ROUNDS, 4), 3)
    round_ns = chain_ms * 1e6 / MESH_ROUNDS
    for fuse in (3, 5, 6, 7, 8):
        out = ops.colskip_sort_mesh_batched(x, 4, w, k, fuse=fuse,
                                            packed=packed, return_rounds=True)
        err = max(err, _hold(f"{name} D=4 fuse={fuse} != local kernel",
                             out[:4], ops.colskip_sort_batched(x, w, k)))
        ms = _time_ms(lambda: ops.colskip_sort_mesh_batched(
            x, 4, w, k, fuse=fuse, packed=packed), 5)
        rounds = int(out[4].max())
        table.append({"banks": 4, "fuse": fuse, "ms": ms,
                      "rounds_max_row": rounds,
                      "static_rounds": collective_rounds(w, n, fuse)[
                          "rounds"],
                      "round_ns": round_ns,
                      "bound_ms": searches * round_ns * 1e-6,
                      "chain_ms": rounds * round_ns * 1e-6})
        print(f"{name} D=4 fuse={fuse}: {ms:.4f} ms at ({b}, {n}) uniform; "
              f"{rounds} exchange rounds on the slowest row (static account "
              f"{table[-1]['static_rounds']}); one cross-bank round "
              f"{round_ns:.1f} ns")
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
    the radix fused top-k entry by instance), ``bench_launches`` the
    benchmark path's (dense colskip, bitonic, the radix threshold entry):
    each kernel's count from the path that carries it."""
    from repro_torch.core.bitmatrix import as_words
    from repro_torch.kernels.bitonic import ops as bitonic_ops, ref as bitonic_ref
    from repro_torch.kernels.colskip import ops as colskip_ops, ref as colskip_ref
    from repro_torch.kernels.radix_topk import ops as radix_ops, ref as radix_ref
    from repro_torch.sortserve import backends
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

    # the radix threshold entry at a serving shape: (8, 4096) sortable
    # words, k=32 (the harness's kernel_bench launches this entry; every
    # serving tile takes the fused top-k entry timed below)
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
                     bench_launches["radix_threshold"],
                     errs["radix_threshold"], ms, plain_ms, r_bytes, None,
                     lib_ms, shape=f"({b}, {n}) sortable uint32 k={k}",
                     launches_of="the threshold entry on the benchmark "
                                 "path (kernel_bench's radix rows)",
                     visited=int(visited.max()), digit_bits=digit,
                     kernel_passes=passes, launch_floor_ms=floor_ms,
                     device_ms=device_ms, host_enqueue_ms=enqueue_ms,
                     launch_floor_device_ms=floor_device_ms,
                     library_device_ms=lib_device_ms,
                     descent_operations=b * n * 5 * passes))

    # the block instance's fused top-k entry as a sort-serving tile runs it
    # at (8, 4096), k=32: the sortable words in, the packed (B, 2k + 1)
    # int32 buffer out (values, indices, plane reads).  Bound: one read of
    # the tile and one write of the buffer; beside it torch.topk on the
    # same words and the backend's whole tile body (host numpy in, numpy
    # out: the copies, the launch and the synchronising copy back)
    def fused():
        return radix_ops.fused_topk(u, k, reads=True, packed=True)

    got = fused()
    want = radix_ops._plain_topk(u, k, reads=True, packed=True)
    err = _max_err(got, want)
    ms = _time_ms(fused, 50)
    device_ms, enqueue_ms = _queued_ms(torch, fused, 50, busy)
    plain_ms = _time_ms(lambda: radix_ops._plain_topk(
        u, k, reads=True, packed=True), 3)
    tile = u.cpu().numpy()
    body = sorted(_host_ms(lambda: backends._radix_select(tile, k, False, dev))
                  for _ in range(21))
    rows.append(_row("radix_block_topk",
                     "src/repro_torch/kernels/radix_topk/csrc/radix_threshold.cu",
                     "src/repro/kernels/radix_topk/kernel.py:48",
                     launches["radix_block_topk"], err, ms, plain_ms,
                     b * n * 4 + b * (2 * k + 1) * 4, None, lib_ms,
                     shape=f"({b}, {n}) sortable uint32 k={k}, packed with "
                           "plane reads",
                     launch_floor_ms=floor_ms, device_ms=device_ms,
                     host_enqueue_ms=enqueue_ms,
                     launch_floor_device_ms=floor_device_ms,
                     library_device_ms=lib_device_ms,
                     tile_body_ms_min=body[0], tile_body_ms_median=body[10]))

    # the narrow instance's fused top-k entry as a sort-serving kmin tile
    # runs it at (8, 1024), k=32: the complement, the plane reads and the
    # packed buffer; bound, torch.topk (the k smallest) and the tile body
    # as above
    b, n, k = 8, 1024, 32
    un = torch.from_numpy(rng.integers(0, 1 << 32, (b, n), dtype=np.uint64)
                          .astype(np.uint32)).to(dev)

    def narrow():
        return radix_ops.fused_topk(un, k, complement=True, reads=True,
                                    packed=True)

    def plain_narrow():
        return radix_ops._plain_topk(un, k, complement=True, reads=True,
                                     packed=True)

    err = _max_err(narrow(), plain_narrow())
    ms = _time_ms(narrow, 50)
    device_ms, enqueue_ms = _queued_ms(torch, narrow, 50, busy)
    plain_ms = _time_ms(plain_narrow, 3)
    keys = as_words(un)
    lib_ms = _time_ms(lambda: torch.topk(keys, k, dim=-1, largest=False), 50)
    lib_device_ms, _ = _queued_ms(
        torch, lambda: torch.topk(keys, k, dim=-1, largest=False), 50, busy)
    tile = un.cpu().numpy()
    body = sorted(_host_ms(lambda: backends._radix_select(tile, k, True, dev))
                  for _ in range(21))
    rows.append(_row("radix_narrow_topk",
                     "src/repro_torch/kernels/radix_topk/csrc/radix_threshold.cu",
                     "src/repro/kernels/radix_topk/kernel.py:48",
                     launches["radix_narrow_topk"], err, ms, plain_ms,
                     b * n * 4 + b * (2 * k + 1) * 4, None, lib_ms,
                     shape=f"({b}, {n}) sortable uint32 k={k} kmin, packed "
                           "with plane reads",
                     launch_floor_ms=floor_ms, device_ms=device_ms,
                     host_enqueue_ms=enqueue_ms,
                     launch_floor_device_ms=floor_device_ms,
                     library_device_ms=lib_device_ms,
                     tile_body_ms_min=body[0], tile_body_ms_median=body[10]))

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


# ---------------------------------------------------------------- phase 8

# the model-serving path at full width: (arch, batch, prompt, new tokens,
# top_k, top_p)
MODEL_RUNS = (("granite-moe-3b-a800m", 4, 128, 32, 16, 0.9),
              ("gemma3-4b", 1, 1536, 16, 64, 0.9),
              ("hymba-1.5b", 4, 64, 32, 16, 0.9),
              ("rwkv6-1.6b", 8, 64, 32, 16, 0.9),
              ("whisper-tiny", 4, 32, 32, 16, 0.9),
              ("qwen2-vl-7b", 2, 256, 16, 64, 0.9))
# decode steps of the profiled run (its trace is processed on the host)
PROFILED_STEPS = 4
# qwen2-vl's patch input: a 16 x 16 grid of patch embeddings, then text
VLM_GRID = 16
VLM_TEXT = 64
# cuda against cpu at smoke size, float32 with TF32 off: cuBLAS and
# F.scaled_dot_product_attention sum in other orders than the host's
# einsums, some ulps a product that grow over two layers (the host and the
# reference differ by 5e-6 at most, tests/test_torch_models.py)
SMOKE_TOL = dict(rtol=1e-4, atol=1e-4)


@contextlib.contextmanager
def _patched(*triples):
    """Set ``module.name = value`` for each triple; restore on exit."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in triples]
    for m, n, v in triples:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _radix_recorder(calls: list):
    """Patches that record every ``radix_topk`` call of the router and the
    sampler as a dict: site, input, k, values, indices, the kernel's
    launches and each launch's (entry, input, k, options), the entry
    "threshold" (``threshold_f32``) or "topk" (the fused ``fused_topk``,
    its options ``bank`` and ``payload`` as the call gave them)."""
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.models import moe
    from repro_torch.serve import sampler
    entries = {"threshold": radix_ops.threshold_f32,
               "topk": radix_ops.fused_topk}
    kernel_inputs = []

    def rec(entry):
        def call(x, k, **opts):
            kept = {o: v.detach().clone() if _is_tensor(v) else v
                    for o, v in opts.items()}
            kernel_inputs.append((entry, x.detach().clone(), k, kept))
            return entries[entry](x, k, **opts)
        return call

    def recorder(site, fn):
        def call(x, k, **kw):
            kernel_inputs.clear()
            before = radix_ops.launches
            vals, idx = fn(x, k, **kw)
            calls.append({"site": site, "x": x.detach().clone(), "k": k,
                          "vals": vals.clone(), "idx": idx.clone(),
                          "launches": radix_ops.launches - before,
                          "kernel": list(kernel_inputs)})
            return vals, idx
        return call

    return _patched((radix_ops, "threshold_f32", rec("threshold")),
                    (radix_ops, "fused_topk", rec("topk")),
                    (moe, "radix_topk", recorder("router", moe.radix_topk)),
                    (sampler, "radix_topk",
                     recorder("sampler", sampler.radix_topk)))


def _is_tensor(v) -> bool:
    import torch
    return isinstance(v, torch.Tensor)


def _moved(opts: dict, to) -> dict:
    """A recorded launch's options with its tensors moved ``to`` a device."""
    return {o: v.to(to) if _is_tensor(v) else v for o, v in opts.items()}


def _plain_kernel(entry: str):
    """The plain version of a radix kernel entry ("threshold" or "topk"),
    on the tensors' own device."""
    from repro_torch.core.topk import to_sortable_uint
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.kernels.radix_topk import ref as radix_ref
    if entry == "topk":
        return radix_ops._plain_topk
    return lambda x, k: radix_ref.threshold_ref(to_sortable_uint(x.float()),
                                                k)


def _plain_threshold():
    """Route ``radix_topk``'s kernel entries (the threshold and the fused
    top-k) through their plain versions on the tensors' own device (the
    card)."""
    from repro_torch.kernels.radix_topk import ops as radix_ops
    return _patched((radix_ops, "threshold_f32", _plain_kernel("threshold")),
                    (radix_ops, "fused_topk", _plain_kernel("topk")))


def _reset_all_launches() -> None:
    from repro_torch.kernels.bitonic import ops as bitonic_ops
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.kernels.radix_topk import ops as radix_ops
    for ops in (bitonic_ops, colskip_ops, radix_ops):
        ops.reset_launches()


def _smoke_run(torch, F, cfg, model, batch, steps) -> list:
    """Prefill, then ``len(steps)`` decode steps: the logits and every
    leaf of the state or cache after each (self-attention caches extended
    by the steps' slots; recurrent and cross-attention leaves as they
    are)."""
    from repro_torch.models import api
    s, n = batch["tokens"].shape[1], len(steps)
    lg, cache = api.prefill(cfg, model, batch)
    got = [("prefill logits", lg)] + [(f"prefill {kk}", cache[kk])
                                      for kk in sorted(cache)]
    cache = {kk: F.pad(vv, (0, 0, 0, 0, 0, n)) if kk in ("k", "v") else vv
             for kk, vv in cache.items()}
    for i in range(n):
        lg, cache = api.decode_step(cfg, model, steps[i], cache, s + i)
        got += [(f"step {i} logits", lg)] + [
            (f"step {i} {kk}", cache[kk].clone()) for kk in sorted(cache)]
    return [(name, g.detach().cpu()) for name, g in got]


def hold_models_smoke(torch, np) -> None:
    """The ten archs at smoke size in float32, TF32 off: one seeded CPU
    model and its copy on the card; prefill logits, 3 decode steps'
    logits and every leaf of the state or cache on cuda against cpu;
    every router call of the cuda run replayed on the host: expert ids
    and gate values exact on the same probabilities.  For the families
    that warm up token by token, the whole prompt through ``decode_step``
    on the card against ``prefill``'s last logits."""
    import copy
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels.radix_topk import radix_topk
    from repro_torch.models import api
    from repro_torch.serve.engine import WARM_FAMILIES
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # hymba's 2 smoke layers are both global ({0, L/2, L-1}): at 4 layers,
    # layer 1 attends within the smoke window of 32, which S = 40 passes
    cases = [(arch, get_config(arch, smoke=True)) for arch in ARCHS]
    cases.append(("hymba-1.5b (4 layers)", dataclasses.replace(
        get_config("hymba-1.5b", smoke=True), n_layers=4)))
    for arch, cfg in cases:
        cpu = api.init(cfg, seed=0, device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        rng = np.random.default_rng(0)
        b, s, n = 2, 40, 3                       # past the smoke window, 32
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (b, s)))}
        if cfg.family == "encdec":
            batch["frames"] = torch.from_numpy(rng.normal(
                size=(b, cfg.enc_ctx, cfg.d_model)).astype(np.float32))
        steps = torch.from_numpy(rng.integers(0, cfg.vocab, (n, b, 1)))
        outs, calls = {}, []
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            rec = (_radix_recorder(calls) if dev == "cuda"
                   else contextlib.nullcontext())
            with rec:
                outs[dev] = _smoke_run(torch, F, cfg, model, batch, steps)
        worst = {}
        for (name, a), (_, c) in zip(outs["cuda"], outs["cpu"]):
            err = float((a - c).abs().max()) if a.numel() else 0.0
            leaf = name.split()[-1]
            worst[leaf] = max(worst.get(leaf, 0.0), err)
            if not (torch.isfinite(a).all() and torch.allclose(a, c,
                                                               **SMOKE_TOL)):
                _fail(f"{arch} smoke: cuda != cpu in {name} (max abs err "
                      f"{err:.3g}, tolerance {SMOKE_TOL})")
        for c in calls:
            vals, idx = radix_topk(c["x"].cpu(), c["k"], device="cpu")
            if not (torch.equal(vals, c["vals"].cpu())
                    and torch.equal(idx, c["idx"].cpu())):
                _fail(f"{arch} smoke: router ids on the card != the host's "
                      f"on the same probabilities {tuple(c['x'].shape)}")
        warm = ""
        if cfg.family in WARM_FAMILIES:
            pl = api.prefill(cfg, gpu, batch)[0]
            cache = api.init_cache(cfg, b, s, model=gpu, device="cuda",
                                   frames=batch.get("frames"))
            for i in range(s):
                lg, cache = api.decode_step(
                    cfg, gpu, batch["tokens"][:, i:i + 1], cache, i)
            err = float((lg - pl).abs().max())
            if not torch.allclose(lg, pl, **SMOKE_TOL):
                _fail(f"{arch} smoke: the warm-up's last logits != prefill's "
                      f"on the card (max abs err {err:.3g})")
            warm = (f"; warm-up of {s} tokens == prefill on the card (max "
                    f"abs err {err:.3g})")
        print(f"phase 8 smoke {arch}: cuda == cpu (float32, TF32 off; "
              f"{SMOKE_TOL}): max abs err "
              + ", ".join(f"{kk} {v:.3g}" for kk, v in sorted(worst.items()))
              + f"; {len(calls)} router calls, expert ids exact on the same "
              f"probabilities{warm}")


def _cpu_events(prof, label):
    return [e for e in prof.events()
            if e.name == label and str(e.device_type).endswith("CPU")]


def _kernel_names(e) -> set:
    names = {k.name for k in e.kernels}
    for ch in e.cpu_children:
        names |= _kernel_names(ch)
    return names


def _radix_kernels(prof, keep=lambda e: True) -> dict:
    """Launches and device ms of the radix library's kernels in a
    profile, by instance.  They are launched through ctypes, outside any
    torch op, so the profiler links them to no annotated range: a label's
    device time holds only its torch glue, and these sums hold the
    kernels."""
    out = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") and "radix_" in e.name \
                and keep(e):
            key = "narrow" if "radix_narrow" in e.name else "block"
            n, ms = out.get(key, (0, 0.0))
            out[key] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return {k: {"launches": n, "device_ms": ms}
            for k, (n, ms) in sorted(out.items())}


def _attention_backends(names) -> list:
    """The SDPA backends a set of kernel names shows: flash, the
    memory-efficient (cutlass fmha) kernel, cuDNN, or the math path (a
    softmax between two products)."""
    found = set()
    for n in names:
        low = n.lower()
        if "cudnn" in low and "sdpa" in low:
            found.add("cudnn")
        elif "flash" in low:
            found.add("flash")
        elif "fmha" in low or "mem_eff" in low:
            found.add("efficient")
        elif "softmax" in low:
            found.add("math")
    return sorted(found)


# labels of the profiled decode step, each a function the step calls
STEP_LABELS = ("decode_step", "sample", "router_radix", "sampler_radix",
               "experts", "attention", "cross_attention", "time_mix",
               "wkv_scan", "mamba")


def _profile_decode(torch, gen, steps: int, warm: bool) -> dict:
    """One ``generate`` under ``torch.profiler`` with the router's and the
    sampler's radix calls, the expert compute, attention and the
    recurrences annotated: device and host ms a decode step of each, and
    the attention kernels' names.  ``warm``: the prompt goes token by
    token through ``decode_step``, and the profiler starts at the first
    sample, after it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import api, blocks, hymba, moe, rwkv6, whisper
    from repro_torch.serve import engine, sampler

    def annotate(label, fn):
        def call(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return call

    sites = ((api, "decode_step", "decode_step"), (engine, "sample", "sample"),
             (moe, "radix_topk", "router_radix"),
             (sampler, "radix_topk", "sampler_radix"),
             (moe, "_dispatch_compute", "experts"),
             (blocks, "_attend_cache", "attention"),
             (whisper, "_attention", "cross_attention"),
             (rwkv6, "_time_mix", "time_mix"),
             (rwkv6, "_wkv_scan", "wkv_scan"),
             (hymba, "_mamba_branch", "mamba"),
             (blocks, "attend", "attention_prefill"))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    with _patched(*[(m, n, annotate(lb, getattr(m, n)))
                    for m, n, lb in sites]):
        annotated_sample, started = engine.sample, []

        def start_then_sample(*a, **kw):
            if not started:
                prof.start()
                started.append(True)
            return annotated_sample(*a, **kw)

        with _patched(*([(engine, "sample", start_then_sample)]
                        if warm else [])):
            if not warm:
                prof.start()
            gen()
            torch.cuda.synchronize()
            prof.stop()
    spans = [(e.time_range.start, e.time_range.end)
             for e in _cpu_events(prof, "decode_step")]
    if len(spans) != steps:
        _fail(f"profiler saw {len(spans)} decode steps, expected {steps}")

    def in_decode(e):
        return any(a <= e.time_range.start < z for a, z in spans)

    out = {}
    for label in STEP_LABELS:
        es = [e for e in _cpu_events(prof, label)
              if label in ("sample", "sampler_radix") or in_decode(e)]
        out[label] = {
            "calls_a_step": len(es) / steps,
            "device_ms": sum(e.device_time_total for e in es) / steps / 1e3,
            "host_ms": sum(e.cpu_time_total for e in es) / steps / 1e3}
    for label in ("attention_prefill", "attention", "cross_attention"):
        names = set()
        for e in _cpu_events(prof, label):
            names |= _kernel_names(e)
        out[f"{label}_backends"] = _attention_backends(names)
    # the radix kernels that ran on the device from the first decode step
    # on: the steps' router calls and the samples between them
    out["radix_kernels"] = {
        k: {"launches_a_step": v["launches"] / steps,
            "device_ms_a_step": v["device_ms"] / steps}
        for k, v in _radix_kernels(
            prof, lambda e: e.time_range.start >= spans[0][0]).items()}
    return out


def _profile_encoder(torch, encode) -> dict:
    """An encoder call's time (CUDA events, mean of 5) and, from one
    profiled call, its kernels' device time, the largest three and the
    attention backend."""
    from torch.profiler import ProfilerActivity, profile
    ms = _time_ms(encode, 5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        encode()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            kernels[e.name] = (kernels.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
    return {"ms": ms, "device_ms": sum(kernels.values()),
            "kernels": len(kernels),
            "top": [[name[:60], t] for name, t in top],
            "attention_backends": _attention_backends(set(kernels))}


def hold_vlm_patches(torch, np, cfg, model, b) -> dict:
    """qwen2-vl's prefill at full width on patch embeddings (a seeded
    generator) with M-RoPE positions of one grid: patch i at (0, i //
    VLM_GRID, i % VLM_GRID), text token j at VLM_GRID + j on all three
    streams.  The logits must be finite and differ from the same call on
    1-D positions (the sections act)."""
    from repro_torch.models import api
    dev = model.device
    p = cfg.vision_patches
    if p != VLM_GRID * VLM_GRID:
        _fail(f"{cfg.name}: {p} patches, not a {VLM_GRID}x{VLM_GRID} grid")
    g = torch.Generator(device=dev).manual_seed(2)
    patches = torch.randn((b, p, cfg.d_model), generator=g, device=dev)
    toks = torch.randint(0, cfg.vocab, (b, VLM_TEXT), generator=g,
                         device=dev)
    i = torch.arange(p, device=dev)
    grid = torch.stack([torch.zeros_like(i), i // VLM_GRID, i % VLM_GRID], -1)
    text = (VLM_GRID + torch.arange(VLM_TEXT, device=dev))[:, None].expand(
        VLM_TEXT, 3)
    pos3 = torch.cat([grid, text])[None].expand(b, p + VLM_TEXT, 3)
    batch = {"tokens": toks, "patches": patches}
    lg, cache = api.prefill(cfg, model, {**batch, "positions3": pos3})
    torch.cuda.synchronize()
    t0 = time.perf_counter()                   # a repeat call, timed
    api.prefill(cfg, model, {**batch, "positions3": pos3})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    flat, _ = api.prefill(cfg, model, batch)
    diff = float((lg.float() - flat.float()).abs().max())
    if not torch.isfinite(lg[..., :cfg.vocab]).all():
        _fail(f"{cfg.name}: prefill logits with patches are not finite")
    if cache["k"].shape[2] != p + VLM_TEXT or diff == 0.0:
        _fail(f"{cfg.name}: M-RoPE positions changed nothing (max abs "
              f"difference {diff})")
    print(f"{cfg.name}: prefill on {p} patch embeddings ({VLM_GRID}x"
          f"{VLM_GRID} grid) + {VLM_TEXT} text tokens, B={b}, M-RoPE "
          f"positions3: logits finite, {ms:.3f} ms; max abs difference "
          f"from 1-D positions {diff:.4g}")
    return {"batch": b, "patches": p, "text": VLM_TEXT, "prefill_ms": ms,
            "max_abs_diff_from_1d_positions": diff}


def run_model(torch, np, card, arch, b, s, new, top_k, top_p) -> dict:
    """``generate`` on the card at the arch's full config: the launch
    count, the replay of every radix call through the plain version, a
    repeat run, the vocab and greedy holds, then the timings."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.kernels.radix_topk import radix_topk
    from repro_torch.models import api, moe, whisper
    from repro_torch.serve import engine, generate, greedy, sampler
    cfg = get_config(arch)
    dev = torch.device("cuda")
    warm = cfg.family in engine.WARM_FAMILIES
    run_t0 = t0 = time.perf_counter()
    model = api.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{arch}: {cfg.n_layers} layers, {n_params:,} stored parameters "
          f"({n_bytes / 2**30:.2f} GiB, {cfg.dtype}), drawn on the card in "
          f"{init_s:.2f} s; B={b}, prompt {s}, {new} new tokens, "
          f"top_k={top_k}, top_p={top_p}")
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (b, s)),
        dtype=torch.int32, device=dev)
    # an encoder's frames: seeded normals, so the cross-attention reads
    # more than zeros
    frames = (torch.as_tensor(np.random.default_rng(1).normal(
        size=(b, cfg.enc_ctx, cfg.d_model)), dtype=torch.float32,
        device=dev) if cfg.family == "encdec" else None)

    def gen(tokens=new):
        g = torch.Generator(device=dev).manual_seed(1)
        return generate(cfg, model, prompts, max_new_tokens=tokens,
                        generator=g, top_k=top_k, top_p=top_p,
                        frames=frames)

    # the main path: every count set to 0 just before, read just after
    calls = []
    _reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _radix_recorder(calls):
        toks = gen()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = radix_ops.launches
    peak = torch.cuda.max_memory_allocated()
    routers = (1 + new) * cfg.n_layers if cfg.moe is not None else 0
    per_sample = 2 if cfg.padded_vocab > radix_ops.MAX_N else 1
    expected = routers + new * per_sample
    print(f"{arch}: radix launches {launches} in the run; the code implies "
          f"{expected} = routers (1 + {new}) x {cfg.n_layers if routers else 0}"
          f" + sampler {new} x {per_sample} (banks, then the manager pass)")
    if launches != expected or launches != sum(c["launches"] for c in calls):
        _fail(f"{arch}: {launches} radix launches, expected {expected}")
    # every router call and every manager pass (vocab banks) or whole vocab
    # row of at most NARROW_N words is one fused launch of the narrow instance
    instances = dict(radix_ops.instance_launches)
    narrow = routers + (new if per_sample == 2
                        or cfg.padded_vocab <= radix_ops.NARROW_N else 0)
    print(f"{arch}: radix launches by instance {json.dumps(instances)}; "
          f"the code implies {narrow} narrow")
    if instances["narrow"] != narrow:
        _fail(f"{arch}: {instances['narrow']} narrow radix launches, "
              f"expected {narrow}")

    t0 = time.perf_counter()
    again = gen()
    torch.cuda.synchronize()
    repeat_s = time.perf_counter() - t0
    if not torch.equal(toks, again):
        _fail(f"{arch}: a repeat run with the same generator differs")
    if not ((toks >= 0) & (toks < cfg.vocab)).all():
        _fail(f"{arch}: sampled ids outside [0, {cfg.vocab})")

    # every recorded radix call through the plain version on the card; the
    # calls of one site, width and k go through as one batch of their rows
    # (a row's top-k depends on its own values only)
    worst = 0.0
    groups = {}
    for c in calls:
        groups.setdefault((c["site"], c["x"].shape[1], c["k"]), []).append(c)
    with _plain_threshold():
        for (site, n, k), cs in groups.items():
            vals, idx = radix_topk(torch.cat([c["x"] for c in cs]), k,
                                   device=dev)
            want_v = torch.cat([c["vals"] for c in cs])
            want_i = torch.cat([c["idx"] for c in cs])
            worst = max(worst, float((vals - want_v).abs().max()),
                        float((idx - want_i).abs().max()))
            if not (torch.equal(vals, want_v) and torch.equal(idx, want_i)):
                _fail(f"{arch}: radix_topk {site} calls at width {n} k={k} "
                      "!= their plain version on the card")
    logits = [c["x"] for c in calls if c["site"] == "sampler"]
    for x in logits:
        if not torch.equal(greedy(x).long(), x.argmax(-1)):
            _fail(f"{arch}: greedy != torch.argmax on a step's logits")
    print(f"{arch}: tokens repeat under the same generator; all < vocab "
          f"{cfg.vocab}; {len(calls)} radix calls equal their plain version "
          f"on the card (values and indices); greedy == argmax on "
          f"{len(logits)} steps' logits")

    # timings: each step synchronised, its host time stamped; the radix
    # calls' host time (enqueue) summed in the decode steps
    stamps, host = [], {"router": 0.0, "sampler": 0.0}

    def stamped(*a, **kw):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return sample(*a, **kw)

    def timed(site, fn):
        def call(x, k, **kw):
            t = time.perf_counter()
            out = fn(x, k, **kw)
            if stamps:
                host[site] += time.perf_counter() - t
            return out
        return call

    sample = engine.sample
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _patched((engine, "sample", stamped),
                  (moe, "radix_topk", timed("router", moe.radix_topk)),
                  (sampler, "radix_topk",
                   timed("sampler", sampler.radix_topk))):
        timed_toks = gen()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    if not torch.equal(timed_toks, toks):
        _fail(f"{arch}: the timed run's tokens differ")
    # the prompt: prefill, or for the warm families the whole token-by-token
    # warm-up (init_cache included)
    prompt_ms = (stamps[0] - t0) * 1e3
    step_ms = np.diff(stamps) * 1e3
    step = float(np.median(step_ms))
    prof = _profile_decode(torch, lambda: gen(PROFILED_STEPS),
                           PROFILED_STEPS, warm)
    busy = prof["decode_step"]["device_ms"] + prof["sample"]["device_ms"]
    out = {
        "arch": arch, "card": card, "layers": cfg.n_layers,
        "stored_params": n_params, "param_gib": n_bytes / 2**30,
        "batch": b, "prompt": s, "new_tokens": new,
        "prompt_path": "warm-up" if warm else "prefill",
        "prompt_ms": prompt_ms, "prompt_ms_a_token": prompt_ms / s,
        "decode_ms_median": step,
        "decode_ms_min": float(step_ms.min()),
        "decode_ms_max": float(step_ms.max()),
        "decode_tok_s": b / step * 1e3,
        "generate_s": repeat_s, "generate_tok_s": b * new / repeat_s,
        "first_generate_s": first_s,
        "max_memory_allocated_gib": peak / 2**30,
        "radix_launches": launches, "radix_launches_implied": expected,
        "radix_max_abs_err": worst,
        "router_radix_host_ms_a_step": host["router"] / new * 1e3,
        "sampler_radix_host_ms_a_step": host["sampler"] / new * 1e3,
        "profile_a_step": {k: v for k, v in prof.items()
                           if k in STEP_LABELS},
        "radix_kernels_a_step": prof["radix_kernels"],
        "step_device_busy_ms": busy,
        "step_idle_share": 1.0 - busy / step,
        "attention_backends": {"prefill": prof["attention_prefill_backends"],
                               "decode": prof["attention_backends"],
                               "cross": prof["cross_attention_backends"]},
    }
    if cfg.family == "encdec":
        out["encoder"] = _profile_encoder(
            torch, lambda: whisper.encode(cfg, model, frames))
        print(f"{card}: {arch} encoder over {tuple(frames.shape)} frames: "
              f"{json.dumps(out['encoder'])}")
    print(f"{card}: {arch} {out['prompt_path']} {prompt_ms:.3f} ms "
          f"({prompt_ms / s:.4f} ms a prompt token); decode "
          f"{step:.3f} ms a step (median of {new}; min "
          f"{step_ms.min():.3f}, max {step_ms.max():.3f}), "
          f"{out['decode_tok_s']:.1f} tok/s decoding; generate "
          f"{repeat_s:.3f} s, {out['generate_tok_s']:.1f} tok/s end to end; "
          f"max_memory_allocated {out['max_memory_allocated_gib']:.3f} GiB")
    for label, v in prof.items():
        if label in STEP_LABELS and v["calls_a_step"]:
            print(f"{card}: {arch} a decode step, {label}: "
                  f"{v['calls_a_step']:.1f} calls, {v['device_ms']:.4f} ms "
                  f"on the device, {v['host_ms']:.4f} ms on the host "
                  "(profiled)")
    print(f"{card}: {arch} a decode step, the radix kernels by instance "
          f"(profiled; no annotated range holds them): "
          f"{json.dumps(prof['radix_kernels'])}")
    print(f"{card}: {arch} a decode step: radix host time (unprofiled) "
          f"router {out['router_radix_host_ms_a_step']:.4f} ms, sampler "
          f"{out['sampler_radix_host_ms_a_step']:.4f} ms; device busy "
          f"{busy:.4f} ms of {step:.4f} ms, idle share "
          f"{out['step_idle_share']:.3f}")
    print(f"{arch}: F.scaled_dot_product_attention's backends: "
          f"{json.dumps(out['attention_backends'])}")
    # one call of each radix shape, for the kernel rows
    path = {}
    for c in calls:
        key = (c["site"], tuple(c["x"].shape), c["k"])
        if key not in path:
            path[key] = dict(c, total_launches=0, calls=0)
        path[key]["total_launches"] += c["launches"]
        path[key]["calls"] += 1
    out["path"] = path
    if cfg.family == "vlm":
        out["patches"] = hold_vlm_patches(torch, np, cfg, model, b)
    out["run_s"] = time.perf_counter() - run_t0
    print(f"phase 8 {arch}: {out['run_s']:.1f} s")
    return out


def _launch_bytes(entry: str, x, k: int, opts: dict) -> int:
    """Bytes one radix launch must move: its rows read once (and a
    payload), its outputs written once: (thresh, visited), or each output
    row's k values and indices (a banked launch: a row a bank)."""
    if entry != "topk":
        return x.numel() * 4 + x.shape[0] * 8
    bank = opts.get("bank", 0)
    rows = x.shape[0] * (-(-x.shape[1] // bank) if bank else 1)
    payload = opts.get("payload")
    return (x.numel() * 4 + (payload.numel() * 4 if payload is not None
                             else 0) + rows * 8 * k)


def radix_path_rows(torch, np, runs: list) -> list:
    """The radix kernel at the model path's shapes: each row times the
    kernel launches of one ``radix_topk`` call (the fused top-k entry: one
    launch, or for a banked vocab row the banks read in place, then the
    manager pass with their indices as its payload), bound by one read of
    their inputs and one write of their outputs, beside their plain
    versions on the card, ``torch.topk`` on the call's rows and the whole
    call (the launches and the views between them).  A row whose launches
    are all fused is named ``radix_narrow_topk_*`` when they all take the
    narrow instance and ``radix_fused_topk_*`` otherwise, else
    ``radix_threshold_*``."""
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.kernels.radix_topk import radix_topk
    busy = lambda: colskip_ops.vote_chain(VOTE_ROUNDS)      # noqa: E731
    floor_ms, _ = _queued_ms(torch, radix_ops.empty_launch, 50, busy)
    entries = {"threshold": radix_ops.threshold_f32,
               "topk": radix_ops.fused_topk}
    rows = []
    for run in runs:
        for (site, shape, k), c in sorted(run["path"].items()):
            kin = c["kernel"]
            if "row_name" in c:
                what = c["row_name"]
            elif site == "router":
                what = ("router_prefill" if shape[0] > run["batch"]
                        else "router_decode")
            else:
                what = f"sampler_{shape[1]}"
            instances = [radix_ops.instance(t.shape[1], o.get("bank", 0))
                         for _, t, _, o in kin]
            if not all(e == "topk" for e, _, _, _ in kin):
                name = "radix_threshold_" + what
            elif all(i == "narrow" for i in instances):
                name = "radix_narrow_topk_" + what
            else:
                name = "radix_fused_topk_" + what

            def kernel():
                for e, x, kk, o in kin:
                    entries[e](x, kk, **o)

            def plain():
                for e, x, kk, o in kin:
                    _plain_kernel(e)(x, kk, **o)

            x, dev = c["x"], c["x"].device
            ms = _time_ms(kernel, 50)
            device_ms, enqueue_ms = _queued_ms(torch, kernel, 50, busy)
            plain_ms = _time_ms(plain, 3)
            lib_ms = _time_ms(lambda: torch.topk(x, k), 50)
            lib_device_ms, _ = _queued_ms(torch, lambda: torch.topk(x, k),
                                          50, busy)
            # a whole call enqueues for some tens of us: few calls, so the
            # busy kernel still covers their enqueue
            call_ms = _time_ms(lambda: radix_topk(x, k, device=dev), 20)
            call_device_ms, call_host_ms = _queued_ms(
                torch, lambda: radix_topk(x, k, device=dev), 4, busy)
            # each launch alone on the device, beside torch.topk on its
            # rows where it is an unbanked top-k
            per_launch = []
            for (e, t, kk, o), inst in zip(kin, instances):
                lb = _launch_bytes(e, t, kk, o)
                per_launch.append({
                    "entry": e, "instance": inst, "tile": list(t.shape),
                    "k": kk, "bank": o.get("bank", 0),
                    "payload": o.get("payload") is not None, "bytes": lb,
                    "bound_ms": lb / HBM_BYTES_PER_S * 1e3,
                    "device_ms": _queued_ms(
                        torch, lambda: entries[e](t, kk, **o), 50, busy)[0],
                    "library_device_ms": _queued_ms(
                        torch, lambda: torch.topk(t, kk), 50, busy)[0]
                    if e == "topk" and not o.get("bank") else None})
            nbytes = sum(p["bytes"] for p in per_launch)
            for p in per_launch:
                lib = ("" if p["library_device_ms"] is None else
                       f"; torch.topk {p['library_device_ms']:.5f} ms")
                opts = (f" bank={p['bank']}" if p["bank"] else "") + \
                    (" payload" if p["payload"] else "")
                print(f"{name} at {shape} k={k}: the {p['entry']} launch on "
                      f"the {p['instance']} instance at {p['tile']} "
                      f"k={p['k']}{opts}: {p['device_ms']:.5f} ms on the "
                      f"device, bound {p['bound_ms']:.7f} ms by bytes, "
                      f"launch floor {floor_ms:.5f} ms{lib}")
            rows.append(_row(
                name, "src/repro_torch/kernels/radix_topk/csrc/radix_threshold.cu",
                "src/repro/kernels/radix_topk/kernel.py:48",
                c["total_launches"], run["radix_max_abs_err"], ms, plain_ms,
                nbytes, None, lib_ms,
                shape=f"{shape} float32 k={k} ({run['arch']} {site})",
                calls_on_path=c["calls"],
                kernel_tiles=[list(t.shape) for _, t, _, _ in kin],
                kernel_entries=[e for e, _, _, _ in kin],
                kernel_instances=instances,
                kernel_launches=per_launch,
                launches_a_call=len(kin), device_ms=device_ms,
                host_enqueue_ms=enqueue_ms,
                launch_floor_device_ms=floor_ms * len(kin),
                library_device_ms=lib_device_ms,
                radix_topk_call_ms=call_ms,
                radix_topk_call_device_ms=call_device_ms,
                radix_topk_call_host_ms=call_host_ms))
    return rows


# ---------------------------------------------------------------- phase 9

# the training path at full width: granite-moe-3b-a800m at its published
# widths and depth, bf16, B = 2 at the reference's train_4k sequence of
# 4,096 (its global batch of 256 cut to 2 for one card), 4 steps
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = (
    "granite-moe-3b-a800m", 2, 4096, 4)
# cuda against cpu, one train step at smoke size in float32 with TF32 off:
# the loss and the grad norm within SMOKE_TOL, each grad leaf within this
# share of the leaf's largest magnitude (the host and the reference differ
# by 3e-6 of it at most, tests/test_torch_loss.py)
TRAIN_GRAD_REL = 1e-4
# microbatches 2 against 1, and resume against a run never stopped: the
# reference's own bars on the params (tests/test_train_and_ckpt.py); a
# step at the default schedule moves no param by more than 3e-6, so the
# microbatched grads are held too, each leaf within this share of its
# largest magnitude (4.2e-7 on the host, tests/test_torch_train.py)
MICROBATCH_TOL = 2e-5
MICROBATCH_GRAD_REL = 1e-5
RESUME_TOL = 1e-6


def _smoke_batch(torch, np, cfg, dev, b=2, s=32):
    """A seeded token batch, with seeded normal frames (encoder-decoder)
    or patches (VLM, beside the launcher's 1-D positions3)."""
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.train import make_batch
    batch = make_batch(cfg, SyntheticCorpus(cfg.vocab, s, b, seed=0).batch(
        0)["tokens"], dev)
    rng = np.random.default_rng(1)
    for key in ("frames", "patches"):
        if key in batch:
            batch[key] = torch.as_tensor(rng.normal(
                size=tuple(batch[key].shape)).astype(np.float32), device=dev)
    return batch


def _train_once(torch, cfg, state, batch, **kw):
    """One ``make_train_step`` at peak_lr 1e-3 with no warm-up -> (metrics
    as floats, every grad on the host by parameter name)."""
    from repro_torch.train import make_train_step
    grads = {}

    def capture(g, _state):
        grads.update({n: t.detach().float().cpu() for n, t in g.items()})
        return g, {}

    _, m = make_train_step(cfg, peak_lr=1e-3, warmup=0, grad_reduce=capture,
                           **kw)(state, batch)
    return {k: float(v) for k, v in m.items()}, grads


def hold_train_smoke(torch, np, dev="cuda") -> dict:
    """The ten archs at smoke size in float32, TF32 off: one seeded CPU
    train state and its copy on the card, one ``make_train_step`` each:
    loss, grad norm, lr and every grad leaf on cuda against cpu, every
    router call's expert ids on the card equal to the host's on the same
    probabilities.  Then on the card: microbatches 2 against 1 (hymba),
    resume from a checkpoint against 4 uninterrupted steps (rwkv6, the
    reference's cases), and that checkpoint restored on the CPU."""
    import copy
    import tempfile
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.ckpt.manager import _flatten, reference_tree
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels.radix_topk import radix_topk
    from repro_torch.train import adamw_init, init_state, make_train_step
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        cpu = init_state(cfg, seed=0, device="cpu")
        model = copy.deepcopy(cpu["model"]).to(dev)
        gpu = {"model": model, "opt": adamw_init(model.named_parameters())}
        calls = []
        got = {}
        for where, state in (("cpu", cpu), ("cuda", gpu)):
            rec = (_radix_recorder(calls) if where == "cuda"
                   else contextlib.nullcontext())
            with rec:
                got[where] = _train_once(torch, cfg, state, _smoke_batch(
                    torch, np, cfg, state["model"].device))
        (mc, gc), (mg, gg) = got["cpu"], got["cuda"]
        for k in ("loss", "grad_norm", "lr", "ce"):
            if not (np.isfinite(mg[k]) and np.isclose(mg[k], mc[k],
                                                      **SMOKE_TOL)):
                _fail(f"{arch} train step: {k} {mg[k]} on the card, "
                      f"{mc[k]} on the host")
        worst = 0.0
        for n, c in gc.items():
            err = float((gg[n] - c).abs().max())
            bound = TRAIN_GRAD_REL * float(c.abs().max())
            worst = max(worst, err / max(float(c.abs().max()), 1e-30))
            if not (torch.isfinite(gg[n]).all() and err <= bound):
                _fail(f"{arch} train step: grad {n} differs by {err:.3g} "
                      f"(bound {bound:.3g})")
        routers = cfg.n_layers * 2 if cfg.moe is not None else 0
        if len(calls) != routers:
            _fail(f"{arch} train step: {len(calls)} router calls, the code "
                  f"implies {routers} (forward and remat recompute)")
        for c in calls:
            vals, idx = radix_topk(c["x"].cpu(), c["k"], device="cpu")
            if not (torch.equal(vals, c["vals"].cpu())
                    and torch.equal(idx, c["idx"].cpu())):
                _fail(f"{arch} train step: router ids on the card != the "
                      "host's on the same probabilities")
        out[arch] = {"loss_abs_err": abs(mg["loss"] - mc["loss"]),
                     "grad_norm_abs_err": abs(mg["grad_norm"]
                                              - mc["grad_norm"]),
                     "grad_max_rel_err": worst, "router_calls": len(calls)}
        print(f"phase 9 smoke {arch}: train step cuda == cpu (float32, TF32 "
              f"off): loss {mg['loss']:.6f} (err {out[arch]['loss_abs_err']:.3g}"
              f"), grad_norm err {out[arch]['grad_norm_abs_err']:.3g}, every "
              f"grad leaf within {worst:.3g} of its largest value (bound "
              f"{TRAIN_GRAD_REL}); {len(calls)} router calls, expert ids exact")

    # microbatches 2 against 1 on the card (hymba, the reference's case):
    # the accumulated grads, which the grad_reduce hook hands out, and the
    # params after the step
    cfg = get_config("hymba-1.5b", smoke=True)
    batch = _smoke_batch(torch, np, cfg, dev, b=4)
    params, grads, metrics = {}, {}, {}
    for mb in (1, 2):
        g = {}

        def capture(gs, _state, g=g):
            g.update({n: t.detach().float().clone() for n, t in gs.items()})
            return gs, {}

        state = init_state(cfg, seed=0, device=dev)
        _, m = make_train_step(cfg, microbatches=mb, grad_reduce=capture)(
            state, batch)
        params[mb] = [p.detach() for p in state["model"].parameters()]
        grads[mb], metrics[mb] = g, {k: float(v) for k, v in m.items()}
    grad_err = 0.0
    for n, g in grads[1].items():
        top = float(g.abs().max())
        if not top > 0:
            _fail(f"microbatches: grad {n} is all zero on the card")
        grad_err = max(grad_err, float((grads[2][n] - g).abs().max()) / top)
    if not grad_err <= MICROBATCH_GRAD_REL:
        _fail(f"microbatches 2 != 1 on the card: a grad leaf differs by "
              f"{grad_err:.3g} of its largest value")
    for k in ("loss", "grad_norm"):
        if not np.isclose(metrics[2][k], metrics[1][k], rtol=1e-5, atol=0):
            _fail(f"microbatches 2 != 1 on the card: {k} {metrics[2][k]} "
                  f"against {metrics[1][k]}")
    err = max(float((a - b).abs().max())
              for a, b in zip(params[1], params[2]))
    if not err <= MICROBATCH_TOL:
        _fail(f"microbatches 2 != 1 on the card: {err:.3g}")
    out["microbatch_max_abs_err"] = err
    out["microbatch_grad_max_rel_err"] = grad_err

    # resume from a checkpoint the card wrote against a straight run
    cfg = get_config("rwkv6-1.6b", smoke=True)
    from repro_torch.data import SyntheticCorpus
    data = SyntheticCorpus(cfg.vocab, 16, 2, seed=3)

    def batch_of(i):
        return {"tokens": torch.as_tensor(data.batch(i)["tokens"],
                                          device=dev)}

    step = make_train_step(cfg, peak_lr=1e-3)
    straight = init_state(cfg, seed=1, device=dev)
    for i in range(4):
        step(straight, batch_of(i))
    with tempfile.TemporaryDirectory() as ck:
        s = init_state(cfg, seed=1, device=dev)
        for i in range(2):
            step(s, batch_of(i))
        mgr = CheckpointManager(ck)
        mgr.save(2, s, blocking=True)
        written = reference_tree(s)
        del s
        s = mgr.restore(2, init_state(cfg, seed=99, device=dev))
        for i in range(2, 4):
            step(s, batch_of(i))
        on_cpu = reference_tree(mgr.restore(
            2, init_state(cfg, seed=5, device="cpu")))
    err = max(float((a.detach() - b.detach()).abs().max()) for a, b in zip(
        straight["model"].parameters(), s["model"].parameters()))
    if not err <= RESUME_TOL:
        _fail(f"resume != uninterrupted on the card: {err:.3g}")
    out["resume_max_abs_err"] = err

    want, got = _flatten(written), _flatten(on_cpu)
    if sorted(got) != sorted(want) or not all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in want):
        _fail("a checkpoint written on the card != its restore on the CPU")
    print(f"phase 9 on the card: microbatches 2 == 1: grads within "
          f"{out['microbatch_grad_max_rel_err']:.3g} of each leaf's largest "
          f"value (bound {MICROBATCH_GRAD_REL}), params within "
          f"{out['microbatch_max_abs_err']:.3g} (bound {MICROBATCH_TOL}); resume == 4 straight steps within "
          f"{out['resume_max_abs_err']:.3g} (bound {RESUME_TOL}); the card's "
          f"checkpoint ({len(want)} leaves) restored on the CPU, equal")
    return out


# labels of the profiled train step, each a function the step calls
TRAIN_LABELS = ("forward", "optimizer", "router_radix", "experts",
                "attention")


def _profile_train_step(torch, step, state, batch) -> dict:
    """One train step under ``torch.profiler``, with the forward (the
    loss), the optimizer, the router's radix calls, the expert compute and
    attention annotated (their recomputes in backward included), and CUDA
    events between the forward, the backward and the optimizer: each
    span's device ms and host ms, all kernels' busy ms, and the attention
    backward kernels' ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import api, blocks, moe
    from repro_torch.train import loop
    marks = []

    def mark():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((e, time.perf_counter()))

    def annotate(label, fn, edges=False):
        def call(*a, **kw):
            with record_function(label):
                out = fn(*a, **kw)
            if edges:
                mark()
            return out
        return call

    update = annotate("optimizer", loop.adamw_update, edges=True)

    def optimizer(*a, **kw):
        mark()
        return update(*a, **kw)

    sites = ((api, "loss", annotate("forward", api.loss, edges=True)),
             (loop, "adamw_update", optimizer),
             (moe, "radix_topk", annotate("router_radix", moe.radix_topk)),
             (moe, "_dispatch_compute",
              annotate("experts", moe._dispatch_compute)),
             (blocks, "attend", annotate("attention", blocks.attend)))
    torch.cuda.synchronize()
    with _patched(*sites), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            acc_events=True) as prof:
        mark()
        step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - marks[0][1]) * 1e3
    if len(marks) != 4:
        _fail(f"profiled train step: {len(marks)} marks, expected 4")
    (e0, h0), (e1, h1), (e2, h2), (e3, h3) = marks
    out = {"step_ms": wall_ms,
           "forward_span": {"device_ms": e0.elapsed_time(e1),
                            "host_ms": (h1 - h0) * 1e3},
           "backward_span": {"device_ms": e1.elapsed_time(e2),
                             "host_ms": (h2 - h1) * 1e3},
           "optimizer_span": {"device_ms": e2.elapsed_time(e3),
                              "host_ms": (h3 - h2) * 1e3}}
    for label in TRAIN_LABELS:
        es = _cpu_events(prof, label)
        out[label] = {"calls": len(es),
                      "device_ms": sum(e.device_time_total for e in es) / 1e3,
                      "host_ms": sum(e.cpu_time_total for e in es) / 1e3}
    # the device's own events, without the labels' spans on its timeline
    kernels = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")
               and e.name not in TRAIN_LABELS]
    out["kernels"] = len(kernels)
    busy, end = 0.0, float("-inf")
    for a, z in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        busy += max(0.0, z - max(a, end))
        end = max(end, z)
    out["device_busy_ms"] = busy / 1e3
    out["attention_backward_device_ms"] = sum(
        e.time_range.elapsed_us() for e in kernels
        if "flash" in e.name.lower() and "bwd" in e.name.lower()) / 1e3
    out["radix_kernels"] = _radix_kernels(prof)
    by_name = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    out["top_kernels"] = [[name[:90], ms, n] for name, (ms, n) in sorted(
        by_name.items(), key=lambda kv: -kv[1][0])[:12]]
    out["attention_backends"] = _attention_backends(
        set().union(*[_kernel_names(e)
                      for e in _cpu_events(prof, "attention")]))
    return out


def _watched(state) -> dict:
    """A few leaves whose change shows that a step moved the weights:
    layer 0's query projection (bf16 at full width) and router (float32),
    and the query projection's float32 master."""
    blk = state["model"].blocks[0]
    return {"blocks.0.attn.wq": blk.attn["wq"],
            "blocks.0.moe.router": blk.moe["router"],
            "master blocks.0.attn.wq":
                state["opt"]["master"]["blocks.0.attn.wq"]}


def run_training(torch, np, card, arch=TRAIN_ARCH, batch=TRAIN_BATCH,
                 seq=TRAIN_SEQ, steps=TRAIN_STEPS, smoke=False) -> dict:
    """``repro_torch.launch.train.main`` at the arch's full config on the
    card: every radix launch count reset just before and read just after
    the run, each step's launches against the count the code implies,
    every router call of the first step replayed through the kernel's
    plain version on the card, the recompute's expert ids against the
    forward's, finite losses and grad norms, parameters that moved; then
    the step's ms (host clock, each step synchronised), tokens/s, peak
    memory beside the train state's bytes, and one profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.kernels.radix_topk import radix_topk
    from repro_torch.launch import train as launch_train
    from repro_torch.data import SyntheticCorpus
    cfg = get_config(arch, smoke=smoke)
    kept, records, calls = {}, [], []
    init, build = launch_train.init_state, launch_train.make_train_step

    def init_kept(*a, **kw):
        t0 = time.perf_counter()
        state = init(*a, **kw)
        torch.cuda.synchronize()
        kept["init_s"] = time.perf_counter() - t0
        kept["state"] = state
        kept["before"] = {n: t.detach().clone()
                          for n, t in _watched(state).items()}
        return state

    def make(*a, **kw):
        step = build(*a, **kw)
        kept["step"] = step

        def timed(state, batch):
            first = not records
            torch.cuda.synchronize()
            before = radix_ops.launches
            t0 = time.perf_counter()
            with (_radix_recorder(calls) if first
                  else contextlib.nullcontext()):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            records.append({"ms": ms, "launches": radix_ops.launches - before,
                            **{k: float(v) for k, v in m.items()}})
            if first:
                kept["moved"] = {
                    n: float((now.detach().float()
                              - kept["before"][n].float()).abs().max())
                    for n, now in _watched(state).items()}
            return state, m
        return timed

    argv = ["--arch", arch, "--batch", str(batch), "--seq", str(seq),
            "--steps", str(steps), "--seed", "0"] + (["--smoke"] if smoke
                                                    else [])
    # the main path: every count set to 0 just before, read just after
    _reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _patched((launch_train, "init_state", init_kept),
                  (launch_train, "make_train_step", make)):
        last = launch_train.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = radix_ops.launches
    peak = torch.cuda.max_memory_allocated()
    state = kept["state"]
    model = state["model"]
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    # params, their grads (the params' dtype), and the f32 master, m and v
    state_bytes = 2 * param_bytes + 3 * 4 * n_params
    per_step = 2 * cfg.n_layers          # each router, and its recompute
    print(f"{arch}: {cfg.n_layers} layers, {n_params:,} parameters "
          f"({param_bytes / 2**30:.3f} GiB, {cfg.dtype}), drawn and their "
          f"AdamW slots made on the card in {kept['init_s']:.2f} s; B="
          f"{batch}, S={seq}, {steps} steps through "
          f"repro_torch.launch.train.main")
    print(f"{arch}: radix launches {launches} in the run, "
          f"{[r['launches'] for r in records]} a step; the code implies "
          f"{per_step} a step = {cfg.n_layers} routers x 2 (forward, remat "
          f"recompute in backward)")
    if len(records) != steps or launches != steps * per_step or any(
            r["launches"] != per_step for r in records):
        _fail(f"{arch}: radix launches {launches}, expected "
              f"{steps * per_step}")
    # every router call is one fused launch of the narrow instance
    instances = dict(radix_ops.instance_launches)
    print(f"{arch}: radix launches by instance {json.dumps(instances)}")
    if instances["narrow"] != launches:
        _fail(f"{arch}: router launches off the narrow instance: "
              f"{instances}")
    for r in records:
        if not all(np.isfinite(r[k]) for k in ("loss", "grad_norm", "lr")):
            _fail(f"{arch}: a step's loss or grad norm is not finite: {r}")
    if last != records[-1]["loss"]:
        _fail(f"{arch}: main returned {last}, the last step's loss is "
              f"{records[-1]['loss']}")
    if not all(v > 0 for v in kept["moved"].values()):
        _fail(f"{arch}: parameters did not move in step 1: {kept['moved']}")

    # one profiled step more, on the run's state
    data = SyntheticCorpus(cfg.vocab, seq, batch, seed=0)
    prof = _profile_train_step(torch, kept["step"], state,
                               launch_train.make_batch(
                                   cfg, data.batch(steps)["tokens"],
                                   model.device))
    moved = kept["moved"]
    del state, model
    kept.clear()
    torch.cuda.empty_cache()

    # the first step's router calls: the forward's and the recompute's
    # (layers in reverse) on the same input give the same ids, and each call
    # equals its plain version on the card
    if len(calls) != per_step:
        _fail(f"{arch}: {len(calls)} router calls recorded, expected "
              f"{per_step}")
    half = cfg.n_layers
    for fwd, rec in zip(calls[:half], calls[half:][::-1]):
        if not (torch.equal(fwd["x"], rec["x"])
                and torch.equal(fwd["idx"], rec["idx"])):
            _fail(f"{arch}: the remat recompute's router call differs from "
                  "the forward's")
    worst = 0.0
    with _plain_threshold():
        for c in calls:
            vals, idx = radix_topk(c["x"], c["k"], device=c["x"].device)
            worst = max(worst, float((vals - c["vals"]).abs().max()),
                        float((idx - c["idx"]).abs().max()))
            if not (torch.equal(vals, c["vals"])
                    and torch.equal(idx, c["idx"])):
                _fail(f"{arch}: a router radix_topk call at "
                      f"{tuple(c['x'].shape)} != its plain version")
    step_ms = np.array([r["ms"] for r in records[1:]] or [records[0]["ms"]])
    med = float(np.median(step_ms))
    busy = prof["device_busy_ms"]
    out = {
        "arch": arch, "card": card, "layers": cfg.n_layers,
        "parameters": n_params, "param_gib": param_bytes / 2**30,
        "batch": batch, "seq": seq, "steps": steps,
        "step_ms": [r["ms"] for r in records],
        "step_ms_median_after_first": med,
        "tokens_per_s": batch * seq / med * 1e3,
        "losses": [r["loss"] for r in records],
        "grad_norms": [r["grad_norm"] for r in records],
        "lrs": [r["lr"] for r in records],
        "max_abs_change_in_step_1": moved,
        "max_memory_allocated_gib": peak / 2**30,
        "train_state_gib": state_bytes / 2**30,
        "radix_launches": launches, "radix_launches_a_step": per_step,
        "radix_max_abs_err": worst, "run_s": run_s,
        "profile": prof, "step_device_busy_ms": busy,
        "step_idle_share": 1.0 - busy / med,
        "profiled_step_idle_share": 1.0 - busy / prof["step_ms"],
    }
    print(f"{card}: {arch} train step {med:.3f} ms (median of steps 2-"
          f"{steps}, host clock, each synchronised; all "
          f"{', '.join(f'{x:.3f}' for x in out['step_ms'])}), "
          f"{out['tokens_per_s']:.1f} tokens/s; losses "
          f"{', '.join(f'{x:.4f}' for x in out['losses'])}; grad norms "
          f"{', '.join(f'{x:.4f}' for x in out['grad_norms'])}; "
          f"max_memory_allocated {out['max_memory_allocated_gib']:.3f} GiB "
          f"beside a train state of {out['train_state_gib']:.3f} GiB")
    for label in ("forward_span", "backward_span", "optimizer_span",
                  *TRAIN_LABELS):
        v = prof[label]
        calls_txt = f"{v['calls']} calls, " if "calls" in v else ""
        print(f"{card}: {arch} a train step, {label}: {calls_txt}"
              f"{v['device_ms']:.3f} ms on the device, {v['host_ms']:.3f} ms "
              "on the host (profiled)")
    print(f"{card}: {arch} a train step, the radix kernels by instance "
          f"(profiled; no annotated range holds them): "
          f"{json.dumps(prof['radix_kernels'])}")
    print(f"{card}: {arch} a train step: device busy {busy:.3f} ms in "
          f"{prof['kernels']} kernels; idle share {out['step_idle_share']:.3f}"
          f" of the {med:.3f} ms step, {out['profiled_step_idle_share']:.3f} "
          f"of the profiled step's {prof['step_ms']:.3f} ms; attention "
          f"backward kernels "
          f"{prof['attention_backward_device_ms']:.3f} ms; attention "
          f"backends {prof['attention_backends']}")
    for name, ms, n in prof["top_kernels"]:
        print(f"{card}: {arch} a train step's kernels: {ms:.3f} ms in {n} "
              f"launches of {name}")
    out["path"] = {("router", tuple(calls[0]["x"].shape), calls[0]["k"]): dict(
        calls[0], total_launches=launches, calls=launches,
        row_name="router_train")}
    print(f"phase 9 {arch}: {run_s:.1f} s for the run")
    return out


# ---------------------------------------------------------------- phase 10

# distribution on the card: ranks that share it, joined by gloo (NCCL
# refuses two ranks on one card), their collectives staged through the
# host
DIST_WORLD, DIST_DEVICE = 4, "cuda:0"
# (a) the §IV selection: sortable rows of 4 banks of 16,384, and one
# layer's expert bank of granite-moe-3b-a800m's gradient (48 padded
# experts x 1536 x 512), each split over the ranks
SORT_ROWS = (8, 4 * 16384)
GRAD_SHAPE = (48, 1536, 512)
# (b) expert-parallel serving: phase 8's granite run on a (data 2, model 2)
# mesh, each data rank 2 of the 4 prompts
EP_MESH = (2, 2)
# The psum adds each rank's experts' bf16 sums (one rounding a rank, one
# more in the sum) where one rank rounds the sum of all 8 once: the first
# MoE layer on one seeded input against one rank's, every expert id equal
# and each output within this share of the largest (4 ulps of bf16)
EP_LAYER_TOL = 2.0 ** -6
# the prefill's last logits (the real ids) against one rank's prefill of
# the same data row's prompts on the same weights (the same capacity):
# the norm of the difference within this share of one rank's norm.  An
# ulp in one layer moves the next layers' router inputs, and a token
# whose 8th and 9th probabilities are that close (random weights route
# near ties) takes another expert from there on
EP_LOGIT_REL = 0.05
EP_LAYER_SHAPE = (2, 128)
# (c) compressed data parallelism: whisper-tiny at its config (bf16), B 2 a
# rank, 3 steps at 1 % of the coordinates; the ratio-1.0 step against the
# plain pmean step at full width in float32 (the plain step sums a bf16
# leaf in bf16, as the reference does, where the compressed one sums in
# float32): the f32 master weights, and the grads the optimizer got, each
# leaf within a share of its largest value; and, on a dense arch at smoke
# size in float32, the plain step's reduced grads against one replica's on
# the whole batch, each leaf within a share of its largest value
DP_ARCH, DP_BATCH, DP_SEQ, DP_STEPS, DP_RATIO = (
    "whisper-tiny", 2, 128, 3, 0.01)
DP_EQ_TOL = 1e-6
DP_ONE_REL = 1e-5
# (d) the pipeline: tanh(x @ w) stages, w (1536, 1536) float32, 8
# microbatches of (4, 128, 1536), TF32 off
PIPE_D, PIPE_M, PIPE_MB = 1536, 8, (4, 128)
PIPE_TOL = 1e-5


def _dist_sort_inputs(torch, dev, kind: str, shape, seed: int, floats: bool):
    """Seeded inputs of one distribution of ``tests/test_distsort.py``:
    uniform, heavy duplicates (7 values) or all equal; sortable words as
    uint32, or float32 gradient entries."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "uniform":
        x = (torch.randn(shape, generator=g, device=dev) if floats else
             torch.randint(0, 1 << 32, shape, generator=g, device=dev))
    elif kind == "duplicates":
        x = torch.randint(0, 7, shape, generator=g, device=dev)
    else:
        x = torch.full(shape, 123456789, device=dev)
    if floats:
        return x.float()
    from repro_torch.core.bitmatrix import to_uint32
    return to_uint32(x.long())


def _dist_selection(torch, mesh) -> dict:
    """(a): kth_largest_sharded, topk_mask_sharded and global_min_sharded
    on this rank's shard against one rank's plain functions on the whole
    tensor (exact), ms a call and collectives a call."""
    from repro_torch.core.distsort import (global_min_sharded,
                                           kth_largest_sharded,
                                           topk_mask_sharded)
    from repro_torch.core.topk import (kth_largest_sortable,
                                       to_sortable_uint, topk_mask)
    from repro_torch.dist import _comm
    dev, n = mesh.device, _comm.axis_size(mesh, "banks")
    i = _comm.axis_index(mesh, "banks")
    out = {}
    for what, shape, floats in (("rows", SORT_ROWS, False),
                                ("grad", GRAD_SHAPE, True)):
        for j, kind in enumerate(("uniform", "duplicates", "equal")):
            full = _dist_sort_inputs(torch, dev, kind, shape, 10 + j, floats)
            full = full.reshape(SORT_ROWS[0] if what == "rows" else 1, -1)
            width = full.shape[-1] // n
            local = full[:, i * width:(i + 1) * width].contiguous()
            u_full, u_local = to_sortable_uint(full), to_sortable_uint(local)
            ks = (64, full.shape[-1] // 100)
            for k in ks:
                fns = {
                    "kth_largest_sharded": (
                        lambda: kth_largest_sharded(u_local, k, mesh, "banks"),
                        lambda: kth_largest_sortable(u_full, k)),
                    "topk_mask_sharded": (
                        lambda: topk_mask_sharded(local, k, mesh, "banks"),
                        lambda: topk_mask(full, k)[
                            :, i * width:(i + 1) * width]),
                }
                if k == ks[0]:
                    fns["global_min_sharded"] = (
                        lambda: global_min_sharded(u_local, mesh, "banks"),
                        lambda: u_full.amin(-1))
                for name, (sharded, whole) in fns.items():
                    torch.cuda.synchronize()
                    _comm.reset_collectives()
                    t0 = time.perf_counter()
                    got = sharded()
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                    if not torch.equal(got, whole()):
                        raise AssertionError(
                            f"{name} on {what} ({kind}, k={k}) != one rank's "
                            "plain version on the whole tensor")
                    key = f"{name} {what} {tuple(full.shape)} {kind} k={k}"
                    out[key] = {"ms": ms, "collectives": _comm.collectives}
            del full, local, u_full, u_local
    torch.cuda.empty_cache()
    return out


def _ep_serving(torch, np, mesh) -> dict:
    """(b): granite-moe-3b-a800m at full width, expert-parallel over the
    ``model`` axis, phase 8's generate on this rank's data shard: the radix
    launches against the count the code implies, every radix call replayed
    through the plain version on the card, a repeat run, the prefill's
    last logits and the first MoE layer, then the timings."""
    from repro_torch.configs import get_config
    from repro_torch.dist import _comm
    from repro_torch.dist.sharding import act_specs
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.kernels.radix_topk import radix_topk
    from repro_torch.models import api, moe
    from repro_torch.serve import engine, generate
    arch, b, s, new, top_k, top_p = MODEL_RUNS[0]
    cfg = get_config(arch)
    dev = mesh.device
    d = _comm.axis_index(mesh, "data")
    rows = b // mesh.shape["data"]
    specs = act_specs(mesh)
    t0 = time.perf_counter()
    model = moe.shard_experts(cfg, api.init(cfg, seed=0, device=dev), mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    init_s = time.perf_counter() - t0
    expert_bytes = sum(blk.moe[k].numel() * blk.moe[k].element_size()
                       for blk in model.blocks for k in ("gate", "up", "down"))
    rest_bytes = sum(p.numel() * p.element_size()
                     for p in model.parameters()) - expert_bytes
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (b, s)),
        dtype=torch.int32, device=dev)[rows * d:rows * (d + 1)]

    def gen(tokens=new):
        # the model ranks of a data row seed alike, and so sample alike
        g = torch.Generator(device=dev).manual_seed(1000 + d)
        return generate(cfg, model, prompts, max_new_tokens=tokens,
                        generator=g, top_k=top_k, top_p=top_p,
                        act_specs=specs)

    calls = []
    _reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    with _radix_recorder(calls):
        toks = gen()
    torch.cuda.synchronize()
    launches = radix_ops.launches
    peak = torch.cuda.max_memory_allocated()
    per_sample = 2 if cfg.padded_vocab > radix_ops.MAX_N else 1
    expected = (1 + new) * cfg.n_layers + new * per_sample
    if launches != expected or launches != sum(c["launches"] for c in calls):
        raise AssertionError(f"{launches} radix launches on this rank, the "
                             f"code implies {expected}")
    if not torch.equal(gen(), toks):
        raise AssertionError("a repeat run with the same generator differs")
    worst = 0.0
    groups = {}
    for c in calls:
        groups.setdefault((c["site"], c["x"].shape[1], c["k"]), []).append(c)
    with _plain_threshold():
        for (site, n, k), cs in groups.items():
            vals, idx = radix_topk(torch.cat([c["x"] for c in cs]), k,
                                   device=dev)
            want_v = torch.cat([c["vals"] for c in cs])
            want_i = torch.cat([c["idx"] for c in cs])
            worst = max(worst, float((vals - want_v).abs().max()),
                        float((idx - want_i).abs().max()))
            if not (torch.equal(vals, want_v) and torch.equal(idx, want_i)):
                raise AssertionError(f"radix_topk {site} calls at width {n} "
                                     f"k={k} != their plain version")
    lg, _ = api.prefill(cfg, model, {"tokens": prompts}, act_specs=specs)
    x = _ep_layer_input(torch, cfg, dev)
    blk = model.blocks[0].moe
    layer_y = moe.apply_moe(cfg, blk, x, act_specs=specs,
                            need_aux=False)[0].float().cpu()
    layer_ids = moe._route(cfg, blk["router"], x.reshape(-1, cfg.d_model))[1]

    # timings: each step synchronised; the collectives' host time from the
    # first sample on is the decode steps' 32 psums each
    stamps, coll = [], []
    sample = engine.sample

    def stamped(*a, **kw):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        coll.append((_comm.collectives, _comm.collective_s))
        return sample(*a, **kw)

    torch.cuda.synchronize()
    _comm.reset_collectives()
    t0 = time.perf_counter()
    with _patched((engine, "sample", stamped)):
        timed = gen()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    coll.append((_comm.collectives, _comm.collective_s))
    if not torch.equal(timed, toks):
        raise AssertionError("the timed run's tokens differ")
    step_ms = np.diff(stamps) * 1e3
    step = float(np.median(step_ms))
    n_decode = coll[-1][0] - coll[0][0]
    # one path entry a router shape, for the kernel rows
    path = {}
    for c in calls:
        if c["site"] != "router":
            continue
        key = (c["site"], tuple(c["x"].shape), c["k"])
        if key not in path:
            path[key] = {
                "x": c["x"].cpu(), "k": c["k"], "calls": 0,
                "total_launches": 0,
                "kernel": [(e, x.cpu(), kk, _moved(o, "cpu"))
                           for e, x, kk, o in c["kernel"]],
                "row_name": ("ep_router_prefill" if key[1][0] > rows
                             else "ep_router_decode")}
        path[key]["calls"] += 1
        path[key]["total_launches"] += c["launches"]
    return {
        "data": d, "model": _comm.axis_index(mesh, "model"),
        "tokens": toks.cpu().numpy(),
        "last_logits": lg[:, -1, :cfg.vocab].float().cpu(),
        "layer_y": layer_y, "layer_ids": layer_ids.cpu(),
        "radix_launches": launches, "radix_launches_implied": expected,
        "radix_calls": len(calls), "radix_max_abs_err": worst,
        "init_s": init_s, "expert_gib": expert_bytes / 2**30,
        "rest_gib": rest_bytes / 2**30,
        "prompt_ms": (stamps[0] - t0) * 1e3, "decode_ms_median": step,
        "decode_tok_s": rows / step * 1e3,
        "max_memory_allocated_gib": peak / 2**30,
        "psums_a_step": n_decode / new,
        "psum_host_ms_a_step": (coll[-1][1] - coll[0][1]) / new * 1e3,
        "path": path, "batch": rows, "arch": arch,
    }


def _dp_training(torch, np, mesh) -> dict:
    """(c): whisper-tiny at full width, make_dp_train_step at 1 % for 3
    steps; ratio 1.0 against the plain pmean step (held in float32,
    printed at the config's bf16); then a dense arch at smoke size, the
    plain step's reduced grads against one replica's on the whole
    batch."""
    from repro_torch.configs import get_config
    from repro_torch.dist import _comm
    from repro_torch.train import (init_dp_state, loop, make_dp_train_step,
                                   make_train_step)
    dev = mesh.device
    n = _comm.axis_size(mesh, "data")
    out = {}
    cfg = get_config(DP_ARCH)
    batch = _smoke_batch(torch, np, cfg, dev, b=DP_BATCH * n, s=DP_SEQ)
    step = make_dp_train_step(cfg, mesh, compress_ratio=DP_RATIO)
    state = init_dp_state(cfg, 0, mesh, compress=True)
    losses, ms, colls = [], [], []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        _comm.reset_collectives()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        colls.append(_comm.collectives)
        losses.append(float(m["loss"]))
    energy = sum(float(e.abs().sum()) for e in state["ef"].values())
    if not all(np.isfinite(losses)) or not energy > 0.0:
        raise AssertionError(f"compressed steps: losses {losses}, residual "
                             f"energy {energy}")
    out.update(losses=losses, step_ms=ms, collectives_a_step=colls,
               residual_l1=energy, ef_leaves=len(state["ef"]))
    del state
    # ratio 1.0 against the plain pmean step, each from the same state:
    # the f32 master weights and the grads the optimizer got.  At bf16 the
    # plain mean rounds each partial sum and the compressed one only its
    # result, and the card's flash attention backward adds in a varying
    # order, so two plain steps differ too (all printed); the hold runs
    # the config in float32 with the math backend, whose backward is the
    # same every run
    from torch.nn.attention import SDPBackend
    from repro_torch.models import blocks
    runs = {}
    update = loop.adamw_update
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def once(tag, ratio, c=cfg):
        seen = {}

        def capture(params, grads, opt, **kw):
            seen.update({k: g.detach().float().clone()
                         for k, g in grads.items()})
            return update(params, grads, opt, **kw)

        st = init_dp_state(c, 0, mesh, compress=ratio is not None)
        torch.cuda.synchronize()
        _comm.reset_collectives()
        t0 = time.perf_counter()
        with _patched((loop, "adamw_update", capture)):
            st, m = make_dp_train_step(c, mesh, compress_ratio=ratio)(
                st, batch)
        torch.cuda.synchronize()
        out[f"{tag}_step_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{tag}_collectives"] = _comm.collectives
        out[f"{tag}_loss"] = float(m["loss"])
        if ratio is not None:
            out[f"{tag}_residual_max"] = max(float(e.abs().max())
                                             for e in st["ef"].values())
        runs[tag] = (st["opt"]["master"], seen)

    def diff(a, b, i):
        return max(float((runs[a][i][k] - runs[b][i][k]).abs().max())
                   for k in runs[a][i])

    def grad_rel(a, b):
        return max(float((runs[a][1][k] - runs[b][1][k]).abs().max())
                   / max(float(runs[a][1][k].abs().max()), 1e-30)
                   for k in runs[a][1])

    once("plain", None)
    once("plain_again", None)
    once("ratio_1", 1.0)
    with _patched((blocks, "_BACKENDS", [SDPBackend.MATH])):
        once("plain_f32", None, cfg32)
        once("ratio_1_f32", 1.0, cfg32)
    for a, b in (("plain", "plain_again"), ("plain", "ratio_1"),
                 ("plain_f32", "ratio_1_f32")):
        out[f"{b}_vs_{a}_master_max_abs"] = diff(a, b, 0)
        out[f"{b}_vs_{a}_grad_max_abs"] = diff(a, b, 1)
        out[f"{b}_vs_{a}_grad_rel"] = grad_rel(a, b)
    err = out["ratio_1_f32_vs_plain_f32_master_max_abs"]
    grel = out["ratio_1_f32_vs_plain_f32_grad_rel"]
    if (err > DP_EQ_TOL or grel > DP_EQ_TOL
            or out["ratio_1_f32_residual_max"] != 0.0):
        raise AssertionError(
            f"ratio 1.0 != the plain pmean step (float32): masters {err}, "
            f"grads {grel} of a leaf's largest, residual "
            f"{out['ratio_1_f32_residual_max']}")
    del runs
    torch.cuda.empty_cache()

    # a dense arch at smoke size (float32): the reduced grads of the plain
    # DP step against one replica's grads on the whole batch
    scfg = get_config("gemma3-4b", smoke=True)
    sbatch = _smoke_batch(torch, np, scfg, dev, b=2 * n, s=32)
    seen = []

    def capture(params, grads, opt, **kw):
        seen.append({k: g.detach().clone() for k, g in grads.items()})
        return update(params, grads, opt, **kw)

    with _patched((loop, "adamw_update", capture)):
        dp_state, _ = make_dp_train_step(scfg, mesh)(
            init_dp_state(scfg, 0, mesh), sbatch)
        one_state, _ = make_train_step(scfg)(
            loop.init_state(scfg, seed=0, device=dev), sbatch)
    worst = 0.0
    for k, g in seen[1].items():
        rel = float((seen[0][k] - g).abs().max()) / max(
            float(g.abs().max()), 1e-30)
        worst = max(worst, rel)
    with torch.no_grad():
        pworst = max(float((p - q).abs().max())
                     / max(float(q.abs().max()), 1e-30)
                     for p, q in zip(dp_state["model"].parameters(),
                                     one_state["model"].parameters()))
    del dp_state, one_state
    if worst > DP_ONE_REL or pworst > DP_ONE_REL:
        raise AssertionError(f"the plain DP step != one replica on the whole "
                             f"batch: grads {worst}, params {pworst}")
    out.update(dense_arch="gemma3-4b smoke", dp_vs_one_grad_rel=worst,
               dp_vs_one_param_rel=pworst)
    return out


def _pipeline(torch, mesh) -> dict:
    """(d): make_pipelined_fn over the ranks against its stages applied
    one after another, float32, TF32 off."""
    from repro_torch.dist import _comm
    from repro_torch.dist.pipeline import make_pipelined_fn
    dev = mesh.device
    n = _comm.axis_size(mesh, "stage")
    g = torch.Generator(device=dev).manual_seed(5)
    ws = torch.randn((n, PIPE_D, PIPE_D), generator=g, device=dev) \
        / PIPE_D ** 0.5
    xs = torch.randn((PIPE_M,) + PIPE_MB + (PIPE_D,), generator=g,
                     device=dev)
    block = lambda w, x: torch.tanh(x @ w)      # noqa: E731
    run = make_pipelined_fn(mesh, block, "stage")
    stage = _comm.axis_index(mesh, "stage")
    got = run(ws[stage], xs)                    # compile nothing: warm up
    torch.cuda.synchronize()
    _comm.reset_collectives()
    t0 = time.perf_counter()
    got = run(ws[stage], xs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = xs
    for i in range(n):
        want = block(ws[i], want)
    err = float((got - want).abs().max())
    if err > PIPE_TOL:
        raise AssertionError(f"pipeline != its stages one after another: "
                             f"{err}")
    return {"ms": ms, "max_abs_err": err, "collectives": _comm.collectives,
            "steps": PIPE_M + n - 1, "staged_through_host": mesh.staged}


# (f) expert-parallel training: granite-moe-3b-a800m at full width on the
# (data 2, model 2) mesh, each rank its 24 experts, cut to EPT_LAYERS of its
# 32 layers (four ranks share the card: at full depth a rank holds some
# 2.2 B parameters, about 37 GB with float32 master, m, v and grads) and
# to EPT_BATCH sequences of EPT_SEQ tokens, in float32 with TF32 off.  The
# step's loss and the grads of EPT_LEAVES against the same ranks' plain
# data-parallel grads (every expert on every rank; no optimizer): the loss
# within EPT_LOSS_REL, each grad's difference within EPT_GRAD_REL of its
# norm.  The psum adds each rank's experts' sums where one rank sums them
# all in another order, so later layers' routers see inputs an ulp apart,
# and a token whose 8th and 9th experts are that close may route apart
EPT_LAYERS, EPT_BATCH, EPT_SEQ = 4, 4, 512
EPT_LEAVES = ("embed", "blocks.0.attn.wq", "blocks.0.moe.router",
              "blocks.3.moe.down", "final_norm.scale")
EPT_LOSS_REL, EPT_GRAD_REL = 1e-4, 1e-2
# (g) the §IV bank mesh over the ranks: a (2, 256) uniform tile, 4 banks
# of 64 columns, stop_after 16, fuse 4, k = 2, exact against the plain
# mesh on the host
BMR_TILE, BMR_STOP, BMR_FUSE = (2, 256), 16, 4


def _ep_training(torch, np, mesh) -> dict:
    """(f): one expert-parallel train step (``make_dp_train_step`` on the
    (data, model) mesh) against the plain data-parallel grads."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.dist import _comm
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.models import api, moe
    from repro_torch.train import init_dp_state, loop, make_dp_train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=EPT_LAYERS,
                              dtype="float32")
    dev = mesh.device
    g = torch.Generator(device="cpu").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (EPT_BATCH, EPT_SEQ),
                           generator=g).to(dev)
    state = init_dp_state(cfg, 0, mesh)
    got = {}
    update = loop.adamw_update

    def capture(params, grads, opt, **kw):
        got.update({k: grads[k].detach().clone() for k in EPT_LEAVES})
        return update(params, grads, opt, **kw)

    step = make_dp_train_step(cfg, mesh)
    loop.adamw_update = capture
    try:
        torch.cuda.synchronize()
        radix_ops.reset_launches()
        _comm.reset_collectives()
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tokens})
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        loop.adamw_update = update
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "step_ms": step_ms, "radix_launches": radix_ops.launches,
           "collectives": _comm.collectives,
           "collective_host_ms": _comm.collective_s * 1e3,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated(dev) / 2**30}
    lo, count = moe.expert_slice(cfg, mesh)
    del state, step
    torch.cuda.empty_cache()
    # the plain data-parallel grads of the same data: every rank every
    # expert, the same initial weights (no optimizer state)
    plain = api.init(cfg, seed=0, device=dev).trainable(True)
    d, n = _comm.axis_index(mesh, "data"), mesh.shape["data"]
    rows = EPT_BATCH // n
    loss, _, grads = loop._grads(cfg, plain, {"tokens":
                                              tokens[d * rows:(d + 1) * rows]})
    loss = _comm.pmean(loss, mesh, "data")
    out["plain_loss"] = float(loss)
    out["loss_rel"] = abs(out["loss"] - out["plain_loss"]) / abs(
        out["plain_loss"])
    rel = {}
    for k in EPT_LEAVES:
        want = _comm.pmean(grads[k], mesh, "data")
        if got[k].shape != want.shape:            # this rank's experts
            want = want[lo:lo + count]
        diff = float((got[k] - want).norm())
        rel[k] = diff / float(want.norm()) if diff else 0.0
    out["grad_rel"] = rel
    del plain, grads
    torch.cuda.empty_cache()
    return out


def _bank_mesh_ranks(torch, np, mesh) -> dict:
    """(g): one tile through ``sharded_tile_fn``, a bank a rank, against
    the plain mesh on the host."""
    from repro_torch.dist import _comm
    from repro_torch.dist.bankmesh import collective_rounds, sharded_tile_fn
    from repro_torch.kernels.colskip.ref import sort_mesh_ref
    x = torch.from_numpy(_rows("uniform", *BMR_TILE, 23))
    banks = mesh.shape["banks"]
    fn = sharded_tile_fn(mesh, "banks", 32, 2, BMR_STOP, True, BMR_FUSE)
    _comm.reset_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = fn(x.to(mesh.device))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = sort_mesh_ref(x, banks, 32, 2, BMR_STOP, fuse=BMR_FUSE)
    err = max(_max_err(g.cpu(), w) for g, w in zip(got, want))
    if err:
        raise AssertionError(f"the bank mesh over ranks != the plain mesh: "
                             f"{err}")
    account = collective_rounds(32, BMR_STOP, BMR_FUSE)["rounds"]
    if not 0 < _comm.collectives <= account:
        raise AssertionError(f"{_comm.collectives} collectives, static "
                             f"account {account}")
    return {"ms": ms, "collectives": _comm.collectives, "account": account,
            "collective_host_ms": _comm.collective_s * 1e3,
            "max_abs_err": err, "device": str(got[0].device)}


def _phase10_rank(rank):
    """Phase 10 on one rank of a gloo group on the card: (a) to (d)."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank}
    t0 = time.perf_counter()
    out["selection"] = _dist_selection(
        torch, make_mesh((DIST_WORLD,), ("banks",), device=DIST_DEVICE))
    out["selection_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = make_mesh(EP_MESH, ("data", "model"), device=DIST_DEVICE)
    out["staged"] = mesh.staged
    out["ep"] = _ep_serving(torch, np, mesh)
    torch.cuda.empty_cache()
    out["ep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dp"] = _dp_training(torch, np, make_mesh((DIST_WORLD,), ("data",),
                                                  device=DIST_DEVICE))
    torch.cuda.empty_cache()
    out["dp_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["pipeline"] = _pipeline(torch, make_mesh((DIST_WORLD,), ("stage",),
                                                 device=DIST_DEVICE))
    out["pipeline_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["ep_train"] = _ep_training(torch, np, make_mesh(
        EP_MESH, ("data", "model"), device=DIST_DEVICE))
    out["ep_train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["bank_mesh"] = _bank_mesh_ranks(torch, np, make_mesh(
        (DIST_WORLD,), ("banks",), device=DIST_DEVICE))
    out["bank_mesh_s"] = time.perf_counter() - t0
    return out


def _phase10_nccl(rank):
    """(e): a one-rank nccl group at smoke size: one DP step (plain and
    compressed: the one-rank axes are identities), one forward of the
    expert-parallel layer, and the collectives the wrappers call, on the
    dtypes they carry."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import act_specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, moe
    from repro_torch.train import init_dp_state, make_dp_train_step
    mesh = make_mesh((1, 1), ("data", "model"), device=DIST_DEVICE)
    dev = mesh.device
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    batch = _smoke_batch(torch, np, cfg, dev, b=2, s=32)
    losses = {}
    for ratio in (None, 0.5):
        st = init_dp_state(cfg, 0, mesh, compress=ratio is not None)
        _, m = make_dp_train_step(cfg, mesh, compress_ratio=ratio)(st, batch)
        losses[str(ratio)] = float(m["loss"])
    model = api.init(cfg, seed=0, device=dev)
    x = torch.randn((2, 8, cfg.d_model), device=dev)
    with torch.no_grad():
        blk = model.blocks[0].moe
        y_ep, _ = moe.apply_moe(cfg, blk, x, act_specs=act_specs(mesh))
        y, _ = moe._apply_moe_auto(cfg, blk, x)
    if not torch.equal(y_ep, y):
        raise AssertionError("the EP layer on one rank != the auto path")
    seen = []
    for dt in (torch.int64, torch.int32, torch.float32, torch.bfloat16):
        t = torch.arange(4, device=dev).to(dt)
        for op in (dist.ReduceOp.SUM, dist.ReduceOp.MAX, dist.ReduceOp.MIN):
            u = t.clone()
            dist.all_reduce(u, op=op)
            if not torch.equal(u, t):
                raise AssertionError(f"nccl all_reduce {op} {dt}")
        parts = [torch.empty_like(t)]
        dist.all_gather(parts, t)
        dist.broadcast(t, 0)
        seen.append(str(dt))
    return {"backend": dist.get_backend(), "losses": losses,
            "dtypes": seen, "ep_forward": list(y_ep.shape)}


def _ep_layer_input(torch, cfg, dev):
    """The seeded input of (b)'s first-layer hold, in the model's dtype."""
    from repro_torch.models.blocks import dtype_of
    g = torch.Generator(device=dev).manual_seed(7)
    return torch.randn(EP_LAYER_SHAPE + (cfg.d_model,), generator=g,
                       device=dev).to(dtype_of(cfg))


def _ep_reference(torch, np) -> dict:
    """One rank on phase 8's granite weights: the prefill of each data
    row's prompts (its last logits on the real ids), and the first MoE
    layer on the seeded input (output and expert ids).  It runs on
    ``DIST_DEVICE`` in the parent process, before the ranks are spawned,
    and hands its results over on the host."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, moe
    arch, b, s = MODEL_RUNS[0][:3]
    cfg = get_config(arch)
    model = api.init(cfg, seed=0, device=DIST_DEVICE)
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (b, s)),
        dtype=torch.int32, device=DIST_DEVICE)
    rows = b // EP_MESH[0]
    logits = []
    for d in range(EP_MESH[0]):
        lg, _ = api.prefill(cfg, model,
                            {"tokens": prompts[rows * d:rows * (d + 1)]})
        logits.append(lg[:, -1, :cfg.vocab].float().cpu())
    x = _ep_layer_input(torch, cfg, DIST_DEVICE)
    with torch.no_grad():
        blk = model.blocks[0].moe
        y = moe.apply_moe(cfg, blk, x, need_aux=False)[0].float().cpu()
        ids = moe._route(cfg, blk["router"], x.reshape(-1, cfg.d_model))[1]
    out = {"logits": torch.cat(logits), "layer_y": y, "layer_ids": ids.cpu()}
    del model
    torch.cuda.empty_cache()
    return out


def run_distribution(torch, np, card) -> dict:
    """Phase 10: the ranks of (a) to (d) on the card over gloo, then (e),
    and the cross-rank holds of (b)."""
    from repro_torch.launch.mesh import spawn
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = _ep_reference(torch, np)
    ref_s = time.perf_counter() - t0
    print(f"phase 10: {DIST_WORLD} ranks on {DIST_DEVICE}, backend gloo (NCCL "
          "refuses two ranks on one card); world size "
          f"{DIST_WORLD}; one rank's granite prefills and first MoE layer "
          f"for (b) in {ref_s:.1f} s")
    t0 = time.perf_counter()
    ranks = spawn(_phase10_rank, DIST_WORLD, backend="gloo",
                  device=DIST_DEVICE, timeout_s=900)
    spawn_s = time.perf_counter() - t0
    r0 = ranks[0]
    print(f"phase 10: collectives staged through the host: "
          f"{r0['staged']} (gloo sends no CUDA tensor between processes); "
          f"the pipeline's ring hops too: "
          f"{r0['pipeline']['staged_through_host']}")
    for key, v in r0["selection"].items():
        print(f"phase 10 (a) {key}: exact against one rank's plain version "
              f"on the whole tensor; {v['ms']:.3f} ms a call (rank 0), "
              f"{v['collectives']} collectives")
    # (b) across ranks: the model ranks of a data row agree, the logits
    # are near one rank's
    ep = [r["ep"] for r in ranks]
    worst_rel = 0.0
    rows = ep[0]["batch"]
    for e in ep:
        twin = next(f for f in ep if f["data"] == e["data"]
                    and f["model"] != e["model"])
        if not np.array_equal(e["tokens"], twin["tokens"]):
            _fail(f"phase 10 (b): the model ranks of data row {e['data']} "
                  "sampled different tokens")
        want = ref["logits"][rows * e["data"]:rows * (e["data"] + 1)]
        rel = float((e["last_logits"] - want).norm() / want.norm())
        worst_rel = max(worst_rel, rel)
        e["last_logits_rel"] = rel
        e["last_logits_max_abs"] = float(
            (e["last_logits"] - want).abs().max())
        e["layer_ids_equal"] = bool(torch.equal(e["layer_ids"],
                                                ref["layer_ids"]))
        e["layer_rel"] = float((e["layer_y"] - ref["layer_y"]).abs().max()
                               / ref["layer_y"].abs().max())
        if not e["layer_ids_equal"] or e["layer_rel"] > EP_LAYER_TOL:
            _fail(f"phase 10 (b): the first MoE layer on rank (data "
                  f"{e['data']}, model {e['model']}): ids equal "
                  f"{e['layer_ids_equal']}, output {e['layer_rel']:.3g} of "
                  f"its largest, bar {EP_LAYER_TOL}")
    print(f"phase 10 (b) prefill last logits against one rank's on the "
          f"data row's prompts: {[round(e['last_logits_rel'], 5) for e in ep]}"
          f" (norm of the difference over the norm, bar {EP_LOGIT_REL})")
    if worst_rel > EP_LOGIT_REL:
        _fail(f"phase 10 (b): prefill logits {worst_rel:.4f} from one "
              f"rank's (norm of the difference over the norm), bar "
              f"{EP_LOGIT_REL}")
    for e in ep:
        print(f"{card}: phase 10 (b) {e['arch']} rank (data {e['data']}, "
              f"model {e['model']}): {e['expert_gib']:.3f} GiB of experts "
              f"+ {e['rest_gib']:.3f} GiB of the rest, drawn in "
              f"{e['init_s']:.1f} s; radix launches {e['radix_launches']} "
              f"(implied {e['radix_launches_implied']}), "
              f"{e['radix_calls']} calls equal to the plain version; "
              f"prompt {e['prompt_ms']:.3f} ms, decode "
              f"{e['decode_ms_median']:.3f} ms a step (median), "
              f"{e['decode_tok_s']:.1f} tok/s on this rank's {rows} rows; "
              f"{e['psums_a_step']:.0f} psums a step, "
              f"{e['psum_host_ms_a_step']:.3f} ms of host time; "
              f"max_memory_allocated {e['max_memory_allocated_gib']:.3f} "
              f"GiB; last logits {e['last_logits_rel']:.5f} of one rank's "
              f"(norm), max abs {e['last_logits_max_abs']:.4f}; first MoE "
              f"layer {e['layer_rel']:.3g} of its largest, ids equal "
              f"{e['layer_ids_equal']}")
    dp = r0["dp"]
    print(f"{card}: phase 10 (c) {DP_ARCH} ({DIST_WORLD} ranks, B "
          f"{DP_BATCH} a rank, S {DP_SEQ}) at {DP_RATIO}: losses "
          f"{dp['losses']}, step ms {[round(m, 3) for m in dp['step_ms']]}, "
          f"collectives a step {dp['collectives_a_step']}, residual L1 "
          f"{dp['residual_l1']:.4g}; ratio 1.0 vs plain pmean (float32, "
          f"math attention): masters "
          f"{dp['ratio_1_f32_vs_plain_f32_master_max_abs']:.3g} (bar "
          f"{DP_EQ_TOL}), grads "
          f"{dp['ratio_1_f32_vs_plain_f32_grad_rel']:.3g} of a leaf's "
          f"largest (bar {DP_EQ_TOL}; max abs "
          f"{dp['ratio_1_f32_vs_plain_f32_grad_max_abs']:.3g}); bf16 with "
          f"flash attention: ratio 1.0 "
          f"{dp['ratio_1_vs_plain_master_max_abs']:.3g} (grads "
          f"{dp['ratio_1_vs_plain_grad_rel']:.3g} of a leaf's largest), a "
          f"plain step again {dp['plain_again_vs_plain_master_max_abs']:.3g}"
          f" (grads {dp['plain_again_vs_plain_grad_rel']:.3g}); steps "
          f"{dp['plain_step_ms']:.3f} / {dp['ratio_1_step_ms']:.3f} "
          f"ms (float32: {dp['plain_f32_step_ms']:.3f} / "
          f"{dp['ratio_1_f32_step_ms']:.3f}), collectives "
          f"{dp['plain_collectives']} / {dp['ratio_1_collectives']}; "
          f"{dp['dense_arch']}: the plain DP "
          f"step's grads {dp['dp_vs_one_grad_rel']:.3g} of one replica's "
          f"(bar {DP_ONE_REL}), params {dp['dp_vs_one_param_rel']:.3g}")
    pipe = r0["pipeline"]
    print(f"{card}: phase 10 (d) pipeline {DIST_WORLD} stages x {PIPE_M} "
          f"microbatches of {PIPE_MB + (PIPE_D,)}: {pipe['ms']:.3f} ms, "
          f"{pipe['steps']} steps, {pipe['collectives']} collectives, max "
          f"abs err {pipe['max_abs_err']:.3g} (bar {PIPE_TOL})")
    for r in ranks:
        e = r["ep_train"]
        print(f"{card}: phase 10 (f) {TRAIN_ARCH} expert-parallel train "
              f"step, rank {r['rank']} of (data, model) {EP_MESH}, "
              f"{EPT_LAYERS} of 32 layers, B {EPT_BATCH} x S {EPT_SEQ}, "
              f"float32: {e['step_ms']:.3f} ms, {e['collectives']} "
              f"collectives staged through the host in "
              f"{e['collective_host_ms']:.3f} ms; radix launches "
              f"{e['radix_launches']}; loss {e['loss']:.6f} against the "
              f"plain DP step's {e['plain_loss']:.6f} ({e['loss_rel']:.3g}, "
              f"bar {EPT_LOSS_REL}); grads against the plain DP step's "
              f"(norm of the difference over the norm, bar {EPT_GRAD_REL}):"
              f" {json.dumps({k: round(v, 8) for k, v in e['grad_rel'].items()})}"
              f"; max_memory_allocated {e['max_memory_allocated_gib']:.3f} "
              "GiB")
        if (e["radix_launches"] <= 0 or e["loss_rel"] > EPT_LOSS_REL
                or max(e["grad_rel"].values()) > EPT_GRAD_REL):
            _fail(f"phase 10 (f) on rank {r['rank']}: {e}")
    for r in ranks:
        b = r["bank_mesh"]
        print(f"{card}: phase 10 (g) the bank mesh over ranks, rank "
              f"{r['rank']} ({b['device']}): {BMR_TILE} uniform, "
              f"{DIST_WORLD} banks, stop_after {BMR_STOP}, fuse "
              f"{BMR_FUSE}: exact against the plain mesh, "
              f"{b['collectives']} collectives (static account "
              f"{b['account']}), {b['ms']:.3f} ms, of it "
              f"{b['collective_host_ms']:.3f} ms staged collectives")
    t0 = time.perf_counter()
    nccl = spawn(_phase10_nccl, 1, backend="nccl", device=DIST_DEVICE,
                 timeout_s=300)[0]
    nccl_s = time.perf_counter() - t0
    print(f"phase 10 (e) one rank on {nccl['backend']}: DP step losses "
          f"{nccl['losses']}, EP forward {nccl['ep_forward']}, all_reduce "
          f"(sum, max, min), all_gather and broadcast on {nccl['dtypes']}; "
          "nothing across cards is measured (one card)")
    print(f"phase 10 ranks: {spawn_s:.1f} s (rank 0: (a) "
          f"{r0['selection_s']:.1f}, (b) {r0['ep_s']:.1f}, (c) "
          f"{r0['dp_s']:.1f}, (d) {r0['pipeline_s']:.1f}, (f) "
          f"{r0['ep_train_s']:.1f}, (g) {r0['bank_mesh_s']:.1f}); (e) "
          f"{nccl_s:.1f} s")
    path = {k: dict(v, x=v["x"].to(DIST_DEVICE),
                    kernel=[(e, x.to(DIST_DEVICE), kk, _moved(o, DIST_DEVICE))
                            for e, x, kk, o in v["kernel"]])
            for k, v in ep[0]["path"].items()}
    run = dict(ep[0], path=path)
    return {"ranks": [{k: v for k, v in r.items() if k != "ep"}
                      for r in ranks],
            "ep": [{k: v for k, v in e.items()
                    if k not in ("path", "tokens", "last_logits", "layer_y",
                                 "layer_ids")}
                   for e in ep],
            "nccl": nccl, "run": run, "spawn_s": spawn_s, "nccl_s": nccl_s}


# ---------------------------------------------------------------- phase 11

# the sort-serving hardware path: the launcher's smoke over the mesh kernel
# at fuse 2 with a persistent kernel-library directory and a profile from
# the port's hw_tune, twice, each in a fresh process
HW_LAUNCH = ["--smoke", "--mesh", "--fuse", "2"]
HW_TUNE_REQUESTS = 4
# the examples' twins (examples/torch/*.py) and what each must print
EXAMPLE_CHECKS = {
    "quickstart": "[cuda] the §III machine reproduces cycles exactly",
    "sort_service": "verify failures: 0",
    "trace_requests": "120 request chains",
    "fleet_serve": "(oracle mismatches: 0)",
    "fleet_view": "ALERT instant(s)",
}
# the dry-run cell traced on meta, beside phase 9's measured step
DRYRUN_CELL = ("granite-moe-3b-a800m", "train_4k")


def _py(args, cwd=None, timeout=900) -> tuple:
    """``python args`` in a fresh process with ``src`` on its path: (exit
    code, stdout, stderr, wall s)."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=cwd or ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr, time.perf_counter() - t0


def _persistent_counts(stdout: str) -> tuple:
    m = re.search(r"persistent cache: (\d+) hits / (\d+) misses", stdout)
    if m is None:
        _fail(f"no persistent cache line in the launcher's output:\n"
              f"{stdout[-2000:]}")
    return int(m.group(1)), int(m.group(2))


def _hw_tune(work: Path) -> tuple:
    """(b), first half: a profile from hw_tune into a fresh directory;
    returns (profile path, cache directory)."""
    cache, prof = work / "kernel_cache", work / "hwprofile.json"
    rc, out, err, tune_s = _py(["-m", "repro_torch.benchmarks.hw_tune",
                                "--out", str(prof), "--cache-dir", str(cache),
                                "--requests", str(HW_TUNE_REQUESTS)])
    if rc != 0:
        _fail(f"hw_tune failed:\n{err[-3000:]}")
    print(out.strip() + f" ({tune_s:.1f} s)")
    return prof, cache


def hw_launcher_runs(prof: Path, cache: Path) -> dict:
    """(b), second half: the launcher twice on the profile's compile
    cache, each in a fresh process, nothing else running."""
    runs = []
    for run in ("cold", "warm"):
        rc, out, err, wall = _py(["-m", "repro_torch.launch.sortserve",
                                  *HW_LAUNCH, "--compile-cache", str(cache),
                                  "--hw-profile", str(prof)])
        if rc != 0 or "oracle mismatches: 0" not in out \
                or "hw profile: " not in out:
            _fail(f"the {run} launcher run returned {rc}:\n{out[-2000:]}\n"
                  f"{err[-2000:]}")
        hits, misses = _persistent_counts(out)
        runs.append({"run": run, "wall_s": wall, "persistent_hits": hits,
                     "persistent_misses": misses})
        print(f"launcher {' '.join(HW_LAUNCH)} --compile-cache "
              f"--hw-profile, {run} process: {wall:.1f} s wall, "
              f"persistent {hits} hits / {misses} misses, 0 oracle "
              "mismatches")
    cold, warm = runs
    if cold["persistent_misses"] <= 0:
        _fail(f"the cold launcher built no library: {cold}")
    if warm["persistent_misses"] != 0 or warm["persistent_hits"] <= 0:
        _fail(f"the warm launcher was not build-free: {warm}")
    return {"cold": cold, "warm": warm}


def start_examples(work: Path) -> dict:
    """(c): the five twins on cuda, started at once, each in its own
    directory; :func:`finish_examples` collects them."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    for name in EXAMPLE_CHECKS:
        cwd = work / name
        cwd.mkdir(parents=True)
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
             "--device", "cuda"], cwd=cwd, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    return procs


def finish_examples(procs: dict, t0: float) -> dict:
    walls = {}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        walls[name] = time.perf_counter() - t0
        if proc.returncode != 0 or EXAMPLE_CHECKS[name] not in out:
            _fail(f"examples/torch/{name}.py returned "
                  f"{proc.returncode}:\n{out[-2000:]}\n{err[-2000:]}")
        print(f"examples/torch/{name}.py on cuda: exit 0 within "
              f"{walls[name]:.1f} s; {out.strip().splitlines()[-1]}")
    return walls


def run_hw_path(train: dict) -> dict:
    """Phase 11 but row 1e: the examples and the dry-run run beside
    hw_tune; the launcher pair runs alone, so its walls are its own."""
    import shutil
    work = ROOT / "build" / "chip_smoke" / "hw"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = start_examples(work / "examples")
    prof, cache = _hw_tune(work)
    dry = dryrun_beside_training(train)
    walls = finish_examples(procs, t0)
    return {"launcher": hw_launcher_runs(prof, cache), "examples_s": walls,
            "dryrun": dry}


def dryrun_beside_training(train: dict) -> dict:
    """(d): one cell's roofline on meta, printed beside phase 9's step."""
    import tempfile
    from repro_torch.launch import dryrun
    arch, shape = DRYRUN_CELL
    with tempfile.TemporaryDirectory() as td:
        rec = dryrun.run_cell(arch, shape, False, td)
    if rec["status"] != "ok":
        _fail(f"dry-run of {arch} {shape} on meta: {rec}")
    rl = rec["roofline"]
    step = train["step_ms_median_after_first"]
    # the cell's device holds 1 of its 256 sequences of 4,096 tokens; the
    # card's step in phase 9 ran 2
    print(f"dry-run {arch} {shape} on meta (a device of 16 x 16, "
          f"{rec['trace_s']} s): compute {rl['t_compute'] * 1e3:.3f} ms, "
          f"memory {rl['t_memory'] * 1e3:.3f} ms, collectives "
          f"{rl['t_collective'] * 1e3:.3f} ms ({rec['collectives']['total']}"
          f" B a device, a model) a device's 4,096 tokens "
          f"({rl['bottleneck']}-bound, useful {rl['useful_ratio']:.3f}); "
          f"twice that, {2e3 * max(rl['t_compute'], rl['t_memory']):.3f} "
          f"ms, beside phase 9's measured {step:.3f} ms for 2 x 4,096 "
          f"tokens; args {rec['mem']['args_gb']} GiB a device")
    return {k: rec[k] for k in ("roofline", "mem", "microbatches",
                                "trace_s", "collectives")}


def measure_hw_mesh(torch, np, hw_launches: int) -> dict:
    """Row 1e: the mesh kernel at hw_bench's shape, (1, 1024) uint32, D = 4,
    F in {1, 2, 4}, each held against the plain mesh (exact), with its own
    rounds; bound: the row's min searches x one cross-bank round."""
    from repro_torch.benchmarks import hw_bench
    from repro_torch.kernels.colskip import ops, ref
    dev = torch.device("cuda")
    w, k, banks = hw_bench.W, 2, hw_bench.BANKS
    host = torch.from_numpy(hw_bench.workload(1)[0].payload[None].copy())
    x = host.to(dev)
    searches = max(_searches(x))
    t0 = time.perf_counter()
    want = ref.sort_mesh_ref(host, banks, w, k, fuse=2)
    plain_ms = (time.perf_counter() - t0) * 1e3
    ops.mesh_chain(1000, banks)
    round_ns = _time_ms(lambda: ops.mesh_chain(MESH_ROUNDS, banks), 3) \
        * 1e6 / MESH_ROUNDS
    table, err = [], 0
    for fuse in hw_bench.FUSE_VALUES:
        got = ops.colskip_sort_mesh_batched(x, banks, w, k, fuse=fuse,
                                            return_rounds=True)
        err = max(err, _hold(f"colskip_mesh (1, {x.shape[1]}) fuse={fuse}",
                             got[:4], want[:4]))
        ms = _time_ms(lambda: ops.colskip_sort_mesh_batched(
            x, banks, w, k, fuse=fuse), 10)
        table.append({"fuse": fuse, "ms": ms,
                      "rounds_max_row": int(got[4].max())})
        print(f"colskip_mesh_hw fuse={fuse}: {ms:.4f} ms at (1, "
              f"{x.shape[1]}) D={banks}, {table[-1]['rounds_max_row']} "
              "exchange rounds")
    main = next(r for r in table if r["fuse"] == 2)
    n = x.shape[1]
    return _row("colskip_mesh_hw",
                "src/repro_torch/kernels/colskip/csrc/colskip_mesh.cu",
                "src/repro/dist/bankmesh.py:126 (not a Pallas kernel)",
                hw_launches, err, main["ms"], plain_ms, n * 4 + n * 8 + 12,
                searches * round_ns * 1e-6, None,
                shape=f"(1, {n}) uint32 w={w} k={k}, D={banks} banks, "
                      "fuse=2 (hw_bench)", plain_device="cpu",
                searches_max_row=searches, round_ns=round_ns,
                rounds_max_row=main["rounds_max_row"], table=table)


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
    print(f"colskip_mesh instances that spill: "
          f"{mesh_spills(logs.get('colskip_mesh', '')) or 'none'}")
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
    serve_mesh(torch, fuse=3)          # a ragged top block of planes
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
        if r["name"] in ("radix_block_topk", "radix_narrow_topk"):
            print(f"{r['name']}: on the device {r['device_ms']:.5f} ms "
                  f"(host enqueue {r['host_enqueue_ms']:.5f} ms a call; "
                  f"torch.topk {r['library_device_ms']:.5f} ms; launch "
                  f"floor {r['launch_floor_device_ms']:.5f} ms); the "
                  f"backend's whole tile body {r['tile_body_ms_median']:.5f}"
                  f" ms (host clock, median of 21; least "
                  f"{r['tile_body_ms_min']:.5f})")
    # 8. the model-serving path: the ten archs at smoke size, then
    # granite-moe-3b-a800m, gemma3-4b, hymba-1.5b, rwkv6-1.6b, whisper-tiny
    # and qwen2-vl-7b at full width
    t0 = time.perf_counter()
    hold_models_smoke(torch, np)
    print(f"phase 8 smoke holds: {time.perf_counter() - t0:.1f} s")
    runs = []
    for run in MODEL_RUNS:
        runs.append(run_model(torch, np, card, *run))
        torch.cuda.empty_cache()
    path_rows = radix_path_rows(torch, np, runs)
    print(json.dumps({"models": [{k: v for k, v in r.items() if k != "path"}
                                 for r in runs]}))
    for r in path_rows:
        print(f"{r['name']}: {r['ms']:.5f} ms the call's {r['launches_a_call']}"
              f" launches at {r['shape']} (tiles {r['kernel_tiles']}, "
              f"entries {r['kernel_entries']}, instances "
              f"{r['kernel_instances']}), "
              f"{r['device_ms']:.5f} ms on the device, launch floor "
              f"{r['launch_floor_device_ms']:.5f} ms; plain "
              f"{r['plain_ms']:.3f} ms; torch.topk {r['library_ms']:.5f} ms "
              f"({r['library_device_ms']:.5f} on the device); the whole "
              f"radix_topk call {r['radix_topk_call_ms']:.5f} ms "
              f"({r['radix_topk_call_device_ms']:.5f} on the device, "
              f"{r['radix_topk_call_host_ms']:.5f} host enqueue); bound "
              f"{r['bound_ms']:.6f} ms by bytes; {r['launches']} launches "
              f"in {r['calls_on_path']} calls on the path")
    rows += path_rows
    print(f"phase 8 (model serving) took {time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{r['arch']} {r['run_s']:.1f} s" for r in runs))
    del runs
    torch.cuda.empty_cache()
    # 9. the training path: the ten archs' train steps at smoke size, cuda
    # against cpu, microbatching, resume and the checkpoint on the card; then
    # granite-moe-3b-a800m at full width through repro_torch.launch.train
    t0 = time.perf_counter()
    smoke_train = hold_train_smoke(torch, np)
    print(f"phase 9 smoke holds: {time.perf_counter() - t0:.1f} s")
    train = run_training(torch, np, card)
    train_rows = radix_path_rows(torch, np, [train])
    for r in train_rows:
        print(f"{r['name']}: {r['ms']:.5f} ms a launch at {r['shape']} "
              f"({r['kernel_entries']} on {r['kernel_instances']}), "
              f"{r['device_ms']:.5f} ms on the device, launch floor "
              f"{r['launch_floor_device_ms']:.5f} ms; plain "
              f"{r['plain_ms']:.3f} ms; torch.topk {r['library_ms']:.5f} ms "
              f"({r['library_device_ms']:.5f} on the device); the whole "
              f"radix_topk call {r['radix_topk_call_ms']:.5f} ms "
              f"({r['radix_topk_call_device_ms']:.5f} on the device, "
              f"{r['radix_topk_call_host_ms']:.5f} host enqueue); bound "
              f"{r['bound_ms']:.6f} ms by bytes; {r['launches']} launches "
              f"in the {TRAIN_STEPS}-step run")
    rows += train_rows
    print(json.dumps({"training": {k: v for k, v in train.items()
                                   if k != "path"},
                      "training_smoke": smoke_train}))
    print(f"phase 9 (training) took {time.perf_counter() - t0:.1f} s")
    # 10. distribution: ranks that share the card, over gloo; then one
    # rank on nccl
    t0 = time.perf_counter()
    distribution = run_distribution(torch, np, card)
    dist_rows = radix_path_rows(torch, np, [distribution["run"]])
    for r in dist_rows:
        print(f"{r['name']}: {r['ms']:.5f} ms a launch at {r['shape']} "
              f"({r['kernel_entries']} on {r['kernel_instances']}), "
              f"{r['device_ms']:.5f} ms on the device, launch floor "
              f"{r['launch_floor_device_ms']:.5f} ms; plain "
              f"{r['plain_ms']:.3f} ms; torch.topk {r['library_ms']:.5f} ms "
              f"({r['library_device_ms']:.5f} on the device); the whole "
              f"radix_topk call {r['radix_topk_call_ms']:.5f} ms; bound "
              f"{r['bound_ms']:.6f} ms by bytes; {r['launches']} launches "
              f"in {r['calls_on_path']} calls on rank 0's path")
    rows += dist_rows
    print(json.dumps({"distribution": {k: v for k, v in distribution.items()
                                       if k != "run"}}, default=str))
    print(f"phase 10 (distribution) took {time.perf_counter() - t0:.1f} s")
    # 11. the sort-serving hardware path: the launcher twice on one compile
    # cache with a hw_tune profile, the five examples, a dry-run cell on
    # meta, and the mesh kernel at hw_bench's shape
    t0 = time.perf_counter()
    hw = run_hw_path(train)
    rows.append(measure_hw_mesh(torch, np, bench_launches["colskip_mesh_hw"]))
    print(json.dumps({"hw_path": hw}))
    print(f"phase 11 (hardware path) took {time.perf_counter() - t0:.1f} s")
    spilled = {k: v for k, v in spills.items() if any(v)}
    if spilled:
        _fail(f"the colskip register path spills: {spilled}")
    # 12. the card again, the timings, and the verdict as the last line
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
