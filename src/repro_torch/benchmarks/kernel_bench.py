"""Kernel microbenchmarks: CR-count telemetry + plane-skip fractions.

The twin of the reference's ``benchmarks/kernel_bench.py``, on the port's
kernels: the radix rows run the threshold kernel's float32 entry
(``threshold_f32``), the bitonic row the bitonic kernel, the colskip rows
the colskip kernel, and ``packed_vs_dense`` both of its mask carriers.
On ``cuda`` they are the CUDA kernels; on ``cpu`` their plain versions.
The paper's metric is column reads; the radix analogue is bit-planes
visited.  Each row times one warm call (:func:`device_timed`) and checks
its output against an independent answer (PASS/MISS), with the
reference's predicates.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.datasets import make_dataset
from repro_torch.core.topk import kth_largest_sortable, to_sortable_uint
from repro_torch.kernels.bitonic import bitonic_sort, n_passes
from repro_torch.kernels.colskip import colskip_sort_batched
from repro_torch.kernels.radix_topk.ops import threshold_f32

from .paper_common import device_timed


def _np(t: torch.Tensor) -> np.ndarray:
    """A result on the host as numpy (uint32 through its int32 view)."""
    t = t.cpu()
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def radix_cases(rng) -> dict:
    """The radix rows' inputs: softmax router probabilities, whose sign and
    high exponent bits are uniform (the leading planes are skipped), and
    wide mixed-sign logits (no skip)."""
    logits = rng.normal(size=(64, 128)).astype(np.float32)
    return {
        "router_probs": torch.softmax(torch.from_numpy(logits), -1).numpy(),
        "logits_wide": (rng.normal(size=(64, 128)) * 10.0).astype(np.float32),
    }


def radix_row(report, name: str, arr: np.ndarray, device: torch.device):
    x = torch.as_tensor(np.array(arr, np.float32), device=device)
    (t, visited), us = device_timed(lambda v: threshold_f32(v, 8), x,
                                    device=device)
    want = kth_largest_sortable(to_sortable_uint(x), 8)
    ok = np.array_equal(_np(t).astype(np.int64), want.cpu().numpy())
    top = int(visited.max())
    report(name=f"kernel/radix_topk/{name}", us_per_call=us,
           derived=(f"planes_visited={top}/32 skip={1 - top / 32:.2f} "
                    + ("PASS" if ok else "MISS")))


def bitonic_row(report, device: torch.device):
    # the merge-sorter analogue: log2N(log2N+1)/2 data-independent passes
    x = np.stack([make_dataset("mapreduce", 1024, 32, seed=s).astype(np.uint32)
                  for s in (1, 2)])
    srt, us = device_timed(lambda a: bitonic_sort(a, device=device),
                           torch.from_numpy(x).to(device), device=device)
    srt = _np(srt)
    ok = all(np.array_equal(srt[i], np.sort(x[i])) for i in range(2))
    report(name="kernel/bitonic_sort/mapreduce_1024", us_per_call=us,
           derived=f"passes={n_passes(1024)} (vs colskip CR-model) "
                   + ("PASS" if ok else "MISS"))


def colskip_rows(report, device: torch.device):
    # CR telemetry of the §III machine on the paper's datasets
    for ds in ["uniform", "mapreduce"]:
        v = np.stack([make_dataset(ds, 128, 32, seed=s).astype(np.uint32)
                      for s in (1, 2)])
        (vals, _, _, cyc), us = device_timed(
            lambda a: colskip_sort_batched(a, 32, 2, device=device),
            torch.from_numpy(v).to(device), device=device)
        vals, cyc = _np(vals), _np(cyc)
        sorted_ok = all(np.array_equal(vals[i], np.sort(v[i]))
                        for i in range(2))
        report(
            name=f"kernel/colskip_sort/{ds}",
            us_per_call=us,
            derived=(f"cyc/num={float(cyc.mean()) / 128:.2f} "
                     f"speedup={32 / (float(cyc.mean()) / 128):.2f}x "
                     + ("PASS" if sorted_ok else "MISS")),
        )


def packed_vs_dense_row(report, device: torch.device):
    # the two mask carriers must agree bit for bit (the 1024-wide timing
    # lives in packed_bench)
    v = np.stack([make_dataset("mapreduce", 128, 32, seed=s).astype(np.uint32)
                  for s in (1, 2)])
    x = torch.from_numpy(v).to(device)
    out_p, us_p = device_timed(lambda a: colskip_sort_batched(
        a, 32, 2, packed=True, device=device), x, device=device)
    out_d, us_d = device_timed(lambda a: colskip_sort_batched(
        a, 32, 2, packed=False, device=device), x, device=device)
    same = all(np.array_equal(_np(a), _np(b)) for a, b in zip(out_p, out_d))
    report(name="kernel/colskip_sort/packed_vs_dense", us_per_call=us_p,
           derived=(f"dense_us={us_d:.0f} speedup={us_d / max(us_p, 1e-9):.2f}x "
                    + ("PASS" if same else "MISS")))


def run(report, device="cuda"):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    for name, arr in radix_cases(rng).items():
        radix_row(report, name, arr, dev)
    bitonic_row(report, dev)
    colskip_rows(report, dev)
    packed_vs_dense_row(report, dev)
