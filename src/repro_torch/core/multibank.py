"""Multi-bank management (paper §IV).

A length-N array is sharded over C memristive banks, each with its own
near-memory sub-sorter over N/C rows.  A multi-bank manager synchronizes the
per-bank enable bits so the C sub-sorters behave as one length-N sorter:

  * the *mixed-column judgement* is computed **globally** — the manager ORs
    the per-bank "saw a 1" / "saw a 0" predicates before enabling RE/SR;
  * CR and SL enables are OR-combined (all banks step their column registers
    together);
  * when repetitions leave survivors in several banks, the manager selects one
    bank at a time to drain its duplicates.

The key claim (§V.C) is that multi-bank management *does not change* the
cycle count of column skipping — it only changes the physical organization
(area/power, modeled in :mod:`repro.core.costmodel`).  Tests assert exact
cycle/order equality against the monolithic :func:`repro.core.colskip.colskip_sort`.

The same OR-reduction of local predicates is what
:mod:`repro.core.distsort` performs with ``jax.lax`` collectives when banks
are devices on a mesh axis — the paper's manager circuit maps 1:1 onto an
ICI all-reduce of two predicate bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .baseline18 import SortResult
from .bitmatrix import BitMatrix

__all__ = ["multibank_colskip_sort"]


@dataclass
class _BankEntry:
    sig: int
    masks: list[np.ndarray]    # per-bank slice of the recorded RE state


class _Bank:
    """One sub-sorter: a bank of rows plus its local near-memory state."""

    def __init__(self, values: np.ndarray, w: int, row0: int):
        self.mem = BitMatrix(values, w)
        self.row0 = row0                       # global row offset
        self.n = self.mem.n
        self.sorted = np.zeros(self.n, dtype=bool)
        self.alive = np.zeros(self.n, dtype=bool)

    # --- local signals sent to the multi-bank manager -------------------
    def sig_any1(self, sig: int) -> bool:
        return bool((self.mem.column(sig) & self.alive).any())

    def sig_any0(self, sig: int) -> bool:
        return bool((~self.mem.column(sig) & self.alive).any())

    # --- synchronized operations (enables come from the manager) --------
    def exclude(self, sig: int) -> None:
        self.alive &= ~self.mem.column(sig)


def multibank_colskip_sort(
    values: np.ndarray, w: int = 32, k: int = 2, banks: int = 4
) -> SortResult:
    """Column-skipping sort over ``banks`` synchronized sub-sorters."""
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    if n % banks:
        raise ValueError(f"N={n} not divisible by banks={banks}")
    nb = n // banks
    subs = [_Bank(values[i * nb:(i + 1) * nb], w, i * nb) for i in range(banks)]

    table: list[_BankEntry] = []        # manager-side: shared indexes/validity
    s_top = w - 1
    order: list[int] = []
    crs = 0
    drains = 0
    iterations = 0
    remaining = n

    while remaining > 0:
        iterations += 1

        # ---- SL: find most recent entry with any unsorted row (global OR)
        entry = None
        while table:
            e = table[0]
            live = any((m & ~b.sorted).any() for m, b in zip(e.masks, subs))
            if live:
                entry = e
                break
            table.pop(0)

        if entry is not None:
            for m, b in zip(entry.masks, subs):
                b.alive = m & ~b.sorted
            start, fresh = entry.sig - 1, False
        else:
            for b in subs:
                b.alive = ~b.sorted
            start, fresh = s_top, True

        # ---- synchronized traversal
        seen_mixed = False
        for sig in range(start, -1, -1):
            crs += 1                                   # CR en (OR-combined)
            any1 = any(b.sig_any1(sig) for b in subs)  # manager OR gates
            any0 = any(b.sig_any0(sig) for b in subs)
            if any1 and any0:                          # global mixed judgement
                for b in subs:                         # ren broadcast
                    b.exclude(sig)
                if fresh:                              # sen broadcast
                    if not seen_mixed:
                        s_top = sig
                        seen_mixed = True
                    table.insert(0, _BankEntry(sig, [b.alive.copy() for b in subs]))
                    del table[k:]

        # ---- output select: drain survivors bank by bank
        m_total = 0
        for b in subs:
            rows = np.flatnonzero(b.alive)
            for r in rows:
                order.append(b.row0 + int(r))
            b.sorted[rows] = True
            m_total += len(rows)
        assert m_total >= 1
        drains += m_total - 1
        remaining -= m_total

    order_arr = np.asarray(order, dtype=np.int64)
    return SortResult(
        order=order_arr,
        values=values[order_arr],
        cycles=crs + drains,
        column_reads=crs,
        drains=drains,
        iterations=iterations,
        meta={"algo": "multibank", "w": w, "k": k, "banks": banks},
    )
