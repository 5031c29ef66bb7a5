"""Quickstart on the PyTorch port: the paper's column-skipping sorter + the
selection engine (the twin of ``examples/quickstart.py``).

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Steps 1-3 run the numpy hardware models on the host; step 4 runs the
§III machine on ``--device`` (the colskip CUDA kernel on ``cuda``, its
plain torch version on ``cpu``) and step 5 the radix top-k (the radix
threshold kernel on ``cuda``) against ``torch.topk``.
"""

import argparse

import numpy as np
import torch

from repro_torch.core.baseline18 import baseline_sort
from repro_torch.core.colskip import colskip_sort
from repro_torch.core.costmodel import baseline_cost, colskip_cost
from repro_torch.core.datasets import make_dataset
from repro_torch.core.jaxsort import colskip_sort_torch
from repro_torch.core.multibank import multibank_colskip_sort
from repro_torch.kernels.radix_topk import radix_topk


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    # --- 1. hardware-faithful simulation (paper Fig. 3 example) ----------
    arr = np.array([8, 9, 10], dtype=np.uint64)
    base = baseline_sort(arr, w=4)
    skip = colskip_sort(arr, w=4, k=2)
    print(f"[fig3] {arr} -> baseline {base.column_reads} CRs, "
          f"column-skipping {skip.column_reads} CRs (paper: 12 vs 7)")

    # --- 2. a real dataset: cycle counts & the paper's headline ----------
    v = make_dataset("mapreduce", 1024, 32, seed=3)
    r = colskip_sort(v, 32, k=2)
    c = colskip_cost(r.cycles_per_number, k=2)
    b = baseline_cost()
    print(f"[mapreduce N=1024] {r.cycles_per_number:.2f} cyc/num "
          f"(speedup {32 / r.cycles_per_number:.2f}x), "
          f"area eff {c.area_eff / b.area_eff:.2f}x, "
          f"energy eff {c.energy_eff / b.energy_eff:.2f}x vs baseline")

    # --- 3. multi-bank: same cycles, smaller circuit ----------------------
    mb = multibank_colskip_sort(v, 32, k=2, banks=16)
    c16 = colskip_cost(mb.cycles_per_number, k=2, banks=16)
    print(f"[multibank Ns=64] cycles identical: {mb.cycles == r.cycles}; "
          f"area {c16.area_kum2:.1f}K vs {c.area_kum2:.1f}K um^2")

    # --- 4. the same algorithm as the port's batched machine --------------
    sv, order, crs, cyc = colskip_sort_torch(
        torch.from_numpy(v.astype(np.uint32)), 32, 2, device=args.device)
    assert int(cyc) == r.cycles
    print(f"[{args.device}] the §III machine reproduces cycles exactly: "
          f"{int(cyc)}")

    # --- 5. batched bit-plane top-k (the selection engine) ---------------
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 151936)).astype(np.float32)).to(args.device)
    vals, idx = radix_topk(logits, 8, device=args.device)
    ref_v, ref_i = torch.topk(logits, 8)
    assert torch.equal(idx.long().cpu(), ref_i.cpu())
    print(f"[radix_topk] top-8 of 151936-wide logits == torch.topk; "
          f"first row ids {idx.cpu().numpy()[0][:4]}...")


if __name__ == "__main__":
    main()
