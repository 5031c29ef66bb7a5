"""Serving-path benchmark: the radix top-k sampler over vocab sizes from
the assigned archs, plus MoE router dispatch.

The twin of the reference's ``benchmarks/serving_bench.py`` on the port's
``radix_topk`` (the radix kernel's fused top-k entry on ``cuda``; rows
wider than its 16,384 words go through the two-level bank path: the banks
read in place by one launch, then the manager pass).  The reference checks
its indices against ``lax.top_k``, which breaks ties by the lowest index;
``torch.topk`` promises no tie order, so here the PASS check is a stable
descending sort of the sortable words, and ``torch.topk`` is only timed
as the yardstick (the port never calls it).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.topk import to_sortable_uint
from repro_torch.kernels.radix_topk import radix_topk

from .paper_common import device_timed


def _same_as_stable_sort(x: torch.Tensor, idx: torch.Tensor, k: int) -> bool:
    """``idx`` equals the first k of a stable descending sort of ``x``'s
    sortable words (value descending, lowest index first among ties)."""
    want = torch.sort(to_sortable_uint(x), dim=-1, descending=True,
                      stable=True).indices[..., :k]
    return torch.equal(idx.to(torch.int64).cpu(), want.cpu())


def run(report, device="cuda"):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)

    for vocab in [32256, 151936, 262144]:
        x = torch.from_numpy(rng.normal(size=(8, vocab)).astype(np.float32)
                             ).to(dev)
        (_, ri), us_r = device_timed(lambda v: radix_topk(v, 64, device=dev),
                                     x, device=dev)
        _, us_t = device_timed(lambda v: torch.topk(v, 64), x, device=dev)
        ok = _same_as_stable_sort(x, ri, 64)
        report(
            name=f"serving/topk64_vocab{vocab}",
            us_per_call=us_r,
            derived=f"radix={us_r:.0f}us torch_topk={us_t:.0f}us "
                    + ("PASS" if ok else "MISS"),
        )

    # MoE router: top-8 of 128 experts across many tokens
    x = torch.from_numpy(rng.normal(size=(16384, 128)).astype(np.float32)
                         ).to(dev)
    (_, ri), us = device_timed(
        lambda v: radix_topk(torch.softmax(v, -1), 8, device=dev), x,
        device=dev)
    ok = _same_as_stable_sort(torch.softmax(x, -1), ri, 8)
    report(name="serving/moe_router_16k_tokens", us_per_call=us,
           derived="top8of128 " + ("PASS" if ok else "MISS"))
