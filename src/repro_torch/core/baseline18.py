"""Baseline memristive in-memory sorter — "Memristive data ranking" [18].

Reference behaviour per the paper's §II.B: N min-search iterations, each a
full w-step bit traversal (MSB -> LSB) of column reads; rows holding 1s in a
*mixed* column are excluded.  The near-memory circuit does **not** track the
number of remaining elements, so every iteration costs exactly ``w`` column
reads and the total latency is ``N * w`` CR cycles — 32 cycles/number at
w=32 for any dataset (paper §V.A).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bitmatrix import BitMatrix

__all__ = ["SortResult", "baseline_sort"]


@dataclass
class SortResult:
    """Output of a hardware-model sort run."""

    order: np.ndarray          # row indices in ascending-value order
    values: np.ndarray         # sorted values
    cycles: int                # total latency in cycles (CR + drain stalls)
    column_reads: int          # CR count alone
    drains: int                # duplicate drain stalls
    iterations: int            # min-search traversals executed
    meta: dict = field(default_factory=dict)

    @property
    def cycles_per_number(self) -> float:
        return self.cycles / max(1, len(self.order))


def baseline_sort(values: np.ndarray, w: int = 32) -> SortResult:
    """Sort via iterative in-memory min computation, counting cycles as [18]."""
    mem = BitMatrix(values, w)
    n = mem.n
    sorted_mask = np.zeros(n, dtype=bool)
    order: list[int] = []
    crs = 0

    for _ in range(n):
        alive = ~sorted_mask
        for sig in range(w - 1, -1, -1):
            crs += 1                      # CR on every column, unconditionally
            if mem.mixed(sig, alive):
                alive = mem.exclude(sig, alive)
        # Survivors all hold the min value; [18] retires one row per
        # iteration (no drain pipeline — duplicates cost a full traversal).
        row = int(np.flatnonzero(alive)[0])
        sorted_mask[row] = True
        order.append(row)

    order_arr = np.asarray(order, dtype=np.int64)
    vals = np.asarray(values, dtype=np.uint64)[order_arr]
    return SortResult(
        order=order_arr,
        values=vals,
        cycles=crs,
        column_reads=crs,
        drains=0,
        iterations=n,
        meta={"algo": "baseline18", "w": w},
    )
