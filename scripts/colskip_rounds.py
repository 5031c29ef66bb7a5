"""Count the colskip kernels' dependent warp rounds per column read.

    PYTHONPATH=src python scripts/colskip_rounds.py [--n 2048] [--seed 5]
        [--dataset uniform] [--rows 1] [--dense] [--mesh D]

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

``--mesh D`` builds ``colskip_mesh.cu`` instead (one library, every fuse)
and sorts each row over D banks, a cluster of D CTAs, at F = 1, 2 and 4
on the carrier: it prints the row's exchange rounds (the kernel's own
``rounds`` output) split by the gate that made them, as the emulation's
tally counts them (block, drain; a load's SL gate makes none, its verdict
rides in the round that ended the last search), beside the reference's
static account (``collective_rounds``).
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
from repro_torch.dist.bankmesh import collective_rounds  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

KINDS = ("ballots", "or", "add", "shuffles")
FUSES = (1, 2, 4)
# warps a row of the dense carrier: kDenseWarps of colskip.cu up to its
# register rows (N <= 2048), one warp for the rolled instance past them
DENSE_WARPS, DENSE_REG_N = 4, 2048
GATES = ("block", "drain")


def row(dataset: str, n: int, seed: int) -> torch.Tensor:
    """One (1, n) row of the dataset, as 32-bit words."""
    x = make_dataset(dataset, n, 32, seed=seed).astype(np.uint32)
    return torch.from_numpy(x.view(np.int32)[None]).contiguous()


def mesh_rounds(args) -> int:
    """Each row's mesh rounds by gate at F in FUSES over ``args.mesh``
    banks."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(_build.sources()["colskip_mesh"], Path(tmp))
    lib.colskip_mesh_launch.argtypes = [vp] * 6 + [i] * 8 + [vp]
    lib.emu_gate_rounds.argtypes = [i]
    lib.emu_gate_rounds.restype = ctypes.c_long
    n, banks, packed = args.n, args.mesh, int(not args.dense)
    carrier = "dense" if args.dense else "packed"
    for r in range(args.rows):
        xt = row(args.dataset, n, args.seed + r)
        out = [torch.zeros((1, n), dtype=torch.int32) for _ in range(2)] + \
              [torch.zeros((1,), dtype=torch.int32) for _ in range(3)]
        print(f"{carrier} mesh, D={banks}: {args.dataset} row {r}, N={n}, "
              f"seed {args.seed + r}, w=32, k=2: "
              f"{len(np.unique(xt.numpy()))} min searches")
        for f in FUSES:
            for g in range(len(GATES)):
                lib.emu_gate_rounds(g)
            err = lib.colskip_mesh_launch(
                xt.data_ptr(), *(o.data_ptr() for o in out), 1, n, banks, 32,
                2, n, f, packed, None)
            if err:
                raise RuntimeError(f"F{f}: error {err}")
            gates = [lib.emu_gate_rounds(g) for g in range(len(GATES))]
            rounds = int(out[4][0])
            if sum(gates) != rounds:
                raise RuntimeError(f"F{f}: {rounds} rounds, {sum(gates)} "
                                   "tallied by gate")
            print(f"F{f}  rounds {rounds} (" + ", ".join(
                f"{g} {c}" for g, c in zip(GATES, gates))
                + f")  static account "
                f"{collective_rounds(32, n, f)['rounds']}  CRs "
                f"{int(out[2][0])}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--dataset", default="uniform")
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--mesh", type=int, default=0,
                    help="banks: the mesh kernel's rounds by gate")
    args = ap.parse_args(argv)
    if args.mesh:
        return mesh_rounds(args)
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
        xt = row(args.dataset, n, args.seed + r)
        x = xt.numpy()
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
