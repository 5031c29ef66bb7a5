"""Shared helpers for the paper-table benchmarks (N=1024, w=32 prototypes).

A copy of the reference's ``benchmarks/paper_common.py`` on
:mod:`repro_torch.core`, plus :func:`device_timed` for the suites that run
on the card."""

from __future__ import annotations

import time

import torch

from repro_torch.core.colskip import colskip_sort
from repro_torch.core.datasets import make_dataset

N = 1024
W = 32
DATASETS = ["uniform", "normal", "clustered", "kruskal", "mapreduce"]
KS = [1, 2, 3, 4]
SEEDS = [3, 7, 11]

# Paper-reported targets (speedup over baseline [18] at 32 cyc/num).
PAPER_BEST_SPEEDUP = {
    "uniform": 1.21, "normal": 1.23, "clustered": 2.22,
    "kruskal": 3.46, "mapreduce": 4.16,
}
PAPER_K2_MAPREDUCE_CYC = 7.84     # Fig. 8a
PAPER_AREA_EFF_X = 3.14           # k=2, MapReduce
PAPER_ENERGY_EFF_X = 3.39


def colskip_cycles_per_num(dataset: str, k: int, seeds=SEEDS, n=N, w=W) -> float:
    """Mean cycles/number of the column-skipping sorter over calibration seeds."""
    tot = 0.0
    for s in seeds:
        v = make_dataset(dataset, n, w, seed=s)
        tot += colskip_sort(v, w, k).cycles_per_number
    return tot / len(seeds)


def timed(fn, *a, **kw):
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, (time.perf_counter() - t0) * 1e6


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def submit_timed(engine, reqs, device: torch.device) -> float:
    """Seconds for ``engine`` to serve ``reqs``, the card synchronised
    before and after."""
    sync(device)
    t0 = time.perf_counter()
    engine.submit(reqs)
    sync(device)
    return time.perf_counter() - t0


def device_timed(fn, *a, device: torch.device):
    """``(fn(*a), us)``: one call to warm up, then the host time of one
    call, with the card synchronised before and after it, so the time
    covers the work and not only its launch (the reference's ``_timed``
    blocks on the result the same way)."""
    fn(*a)
    sync(device)
    t0 = time.perf_counter()
    out = fn(*a)
    sync(device)
    return out, (time.perf_counter() - t0) * 1e6
