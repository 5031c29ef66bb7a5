"""Count the colskip kernels' dependent warp rounds per column read.

    PYTHONPATH=src python scripts/colskip_rounds.py [--n 2048] [--seed 5]
        [--dataset uniform] [--rows 1] [--dense]

Builds ``colskip.cu`` for the CPU emulation of ``tests/cuda_emu/`` (g++,
no card) at each fusion depth (``-DCOLSKIP_FUSE=1``, ``2`` (the kernel's)
and ``4``), sorts rows of a paper dataset (by default row 0 of the
(8, 2048) uniform tile that ``chip_smoke.py`` times; row r is made with
seed + r, as the timed tiles are) with w=32, k=2, and prints the warp
collectives each build issued (ballots, OR and add reductions, shuffles)
against each row's column reads (CRs).  ``--dense`` sorts on the dense
carrier, whose row is several warps: its counts are divided by the warps
a row, so both carriers count a row's rounds.  Each OR reduction is one
dependent round of the row's chain (a fused block or a table load); the
add reductions and the drains' ballots ride in the same rounds, and the
packed kernel's first N ballots pack the planes, off the chain.  Rounds
are counts, not times: the times come from the card.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from _cuda_emu import build  # noqa: E402
from repro_torch.core.datasets import make_dataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

KINDS = ("ballots", "or", "add", "shuffles")
FUSES = (1, 2, 4)
# warps a row of the dense carrier: kDenseWarps of colskip.cu up to its
# register rows (N <= 2048), one warp for the rolled instance past them
DENSE_WARPS, DENSE_REG_N = 4, 2048


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--dataset", default="uniform")
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--dense", action="store_true")
    args = ap.parse_args(argv)
    vp, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for f in FUSES:
            lib = libs[f] = build(_build.sources()["colskip"], Path(tmp),
                                  [f"COLSKIP_FUSE={f}"])
            lib.colskip_sort_launch.argtypes = [vp] * 5 + [i] * 6 + [vp]
            lib.emu_rounds.argtypes = [i]
            lib.emu_rounds.restype = ctypes.c_long
    n, packed = args.n, int(not args.dense)
    warps = 1 if packed or n > DENSE_REG_N else DENSE_WARPS
    carrier = "dense" if args.dense else "packed"
    for r in range(args.rows):
        x = make_dataset(args.dataset, n, 32,
                         seed=args.seed + r).astype(np.uint32)
        xt = torch.from_numpy(x.view(np.int32)[None]).contiguous()
        out = [torch.zeros((1, n), dtype=torch.int32) for _ in range(2)] + \
              [torch.zeros((1,), dtype=torch.int32) for _ in range(2)]
        ptrs = [xt.data_ptr(), *(o.data_ptr() for o in out), 1, n, 32, 2, n]
        print(f"{carrier}: {args.dataset} row {r}, N={n}, seed "
              f"{args.seed + r}, w=32, k=2: {len(np.unique(x))} min searches")
        for f, lib in libs.items():
            name = f"F{f}" + (" (kernel)" if f == 2 else "")
            for kind in range(len(KINDS)):
                lib.emu_rounds(kind)
            err = lib.colskip_sort_launch(*ptrs, packed, None)
            if err:
                raise RuntimeError(f"{name}: error {err}")
            counts = [lib.emu_rounds(kind) // warps
                      for kind in range(len(KINDS))]
            crs, cyc = int(out[2][0]), int(out[3][0])
            print(f"{name:12s} CRs {crs} cycles {cyc}  " + "  ".join(
                f"{k} {c}" for k, c in zip(KINDS, counts))
                  + f"  OR rounds a CR {counts[1] / crs:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
