"""Packed hot path: lane-packed §III machine vs dense, cold vs warm serving.

The twin of the reference's ``benchmarks/packed_bench.py``.
``packed/colskip_sim_1024`` times the colskip kernel on the paper's
N=1024 geometry with both mask carriers **in the same run** — tiles/s,
CR telemetry parity, and the packed speedup.  The reference times its
jitted simulator (``use_pallas=False``), the engine's path off the TPU;
the port has no jitted simulator (its plain version is for tests), so on
``cuda`` the rows keep their names and time the two CUDA kernels.
``packed/serving`` serves one workload twice through a fresh engine
against a cleared executor cache: the first pass builds every tile
signature's launcher, the second runs on warm launchers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.datasets import make_dataset
from repro_torch.kernels.colskip import colskip_sort_batched
from repro_torch.sortserve import EngineConfig, SortRequest, SortServeEngine
from repro_torch.sortserve.backends import EXECUTOR_CACHE

from .paper_common import submit_timed, sync

TILE_B, TILE_N = 8, 1024


def _tiles_per_s(x, packed: bool, device, reps: int = 5):
    out = colskip_sort_batched(x, 32, 2, packed=packed, device=device)
    sync(device)
    dt = float("inf")                 # best-of-N: robust to scheduler noise
    for _ in range(reps):
        t0 = time.perf_counter()
        out = colskip_sort_batched(x, 32, 2, packed=packed, device=device)
        sync(device)
        dt = min(dt, time.perf_counter() - t0)
    return 1.0 / dt, dt, int(out[2].sum())


def _requests(rng, count: int, n: int):
    return [SortRequest("sort", rng.integers(0, 1 << 32, n, dtype=np.uint64)
                        .astype(np.uint32)) for _ in range(count)]


def run(report, device="cuda"):
    dev = resolve_device(device)
    # --- packed vs dense machine at the paper's 1024-wide geometry -------
    x = torch.from_numpy(np.stack([
        make_dataset("mapreduce", TILE_N, 32, seed=s).astype(np.uint32)
        for s in range(TILE_B)])).to(dev)
    tps_p, dt_p, crs_p = _tiles_per_s(x, True, dev)
    tps_d, dt_d, crs_d = _tiles_per_s(x, False, dev)
    speedup = tps_p / tps_d
    parity = crs_p == crs_d
    report(name=f"packed/colskip_sim_{TILE_N}/packed", us_per_call=dt_p * 1e6,
           derived=f"tiles_per_s={tps_p:.2f} column_reads={crs_p}")
    report(name=f"packed/colskip_sim_{TILE_N}/dense", us_per_call=dt_d * 1e6,
           derived=f"tiles_per_s={tps_d:.2f} column_reads={crs_d}")
    report(name=f"packed/colskip_sim_{TILE_N}/speedup", us_per_call=0.0,
           derived=(f"packed_speedup={speedup:.2f}x cr_parity="
                    f"{'exact' if parity else 'BROKEN'} "
                    + ("PASS" if parity and speedup >= 1.5 else "MISS")))

    # --- cold vs warm serving through the executor cache ------------------
    EXECUTOR_CACHE.clear()                 # force a genuinely cold first pass
    rng = np.random.default_rng(0)
    engine = SortServeEngine(EngineConfig(
        backends=("colskip", "jaxsort"), tile_rows=8, banks=8,
        bank_width=1024, sim_width_cap=512, cache_size=0, device=device))
    cold = submit_timed(engine, _requests(rng, 32, 256), dev)
    warm = submit_timed(engine, _requests(rng, 32, 256), dev)
    telem = engine.telemetry()
    hit_rate = telem["executor_cache"]["hit_rate"]
    report(name="packed/serving_cold_b32", us_per_call=cold * 1e6 / 32,
           derived=f"{32 / cold:.0f}req/s compiles="
                   f"{telem['executor_cache']['misses']}")
    report(name="packed/serving_warm_b32", us_per_call=warm * 1e6 / 32,
           derived=(f"{32 / warm:.0f}req/s warm_speedup={cold / warm:.1f}x "
                    f"exec_cache_hit_rate={hit_rate:.2f} "
                    + ("PASS" if warm < cold and hit_rate > 0 else "MISS")))
