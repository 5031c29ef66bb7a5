"""Column-skipping memristive in-memory sorting (the paper's contribution).

Implements the §III algorithm with a k-entry state controller:

  * **SR (state recording)** — during a *fresh* traversal (one that starts
    from the MSB / certified start column with the full unsorted set), each
    mixed column's post-RE surviving-row mask and its column index are pushed
    into a k-entry most-recent-first table.
  * **SL (state loading)** — at the start of a min-search iteration, the most
    recent table entry whose mask still contains unsorted rows is reloaded and
    the traversal resumes at column ``s - 1`` (skipping every column above).
    Entries whose masks are fully retired are invalidated (popped) —
    exactly the hardware's stale-entry behaviour.
  * **Leading-uniform skip** — scenario (1) of §III.A: columns observed
    all-0/all-1 over a superset of the current unsorted rows stay uniform for
    any subset, so fresh traversals start at the deepest certified column
    ``s_top`` rather than the MSB.
  * **Repetition stall** — when several rows survive a full traversal
    (duplicate values), the column processor stalls and the row processor
    drains one duplicate per cycle without issuing new CRs (§III.B).

Cycle accounting matches the paper's: 1 cycle per CR; draining ``m``
duplicates after a traversal costs ``m - 1`` stall cycles (the first retire
overlaps the traversal, which keeps the baseline at exactly ``N*w``).

Correctness sketch (proved in tests/property): every table entry ``(s, M)``
satisfies (a) all rows of ``M`` agree on every column above ``s``; and (b) any
unsorted row outside ``M`` is strictly greater than every row of ``M``, so the
global min of the unsorted set always lies in ``M ∩ unsorted`` while that set
is non-empty, and resuming at ``s-1`` is exact.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .baseline18 import SortResult
from .bitmatrix import BitMatrix

__all__ = ["colskip_sort", "StateController"]


@dataclass
class _Entry:
    sig: int               # column index s (significance; w-1 = MSB)
    mask: np.ndarray       # post-RE surviving-row mask (bool[N])


class StateController:
    """k-entry table of the most recent RE states (paper Fig. 4)."""

    def __init__(self, k: int):
        self.k = int(k)
        self.entries: list[_Entry] = []   # most-recent-first

    def record(self, sig: int, mask: np.ndarray) -> None:
        if self.k <= 0:
            return
        self.entries.insert(0, _Entry(sig, mask.copy()))
        del self.entries[self.k:]

    def load(self, sorted_mask: np.ndarray) -> _Entry | None:
        """Most recent entry still holding unsorted rows; pops dead entries."""
        while self.entries:
            e = self.entries[0]
            if (e.mask & ~sorted_mask).any():
                return e
            self.entries.pop(0)          # stale — invalidate permanently
        return None


def colskip_sort(values: np.ndarray, w: int = 32, k: int = 2,
                 stop_after: int | None = None) -> SortResult:
    """Column-skipping sort; returns order, values, and exact cycle counts.

    ``stop_after=k'`` is the k-early-exit drain (top of ROADMAP follow-ups):
    the hardware stops after the first ``k'`` minima are produced instead of
    completing the sort, so ``order``/``values`` have length ``k'`` and the
    cycle count covers only the iterations (and partial final drain) actually
    executed — the k-min serving mode of the §III machine.
    """
    mem = BitMatrix(values, w)
    n = mem.n
    stop = n if stop_after is None else min(int(stop_after), n)
    if stop < 1:
        raise ValueError(f"stop_after={stop_after} must be >= 1")
    sorted_mask = np.zeros(n, dtype=bool)
    table = StateController(k)
    s_top = w - 1                 # deepest certified uniform-prefix column
    order: list[int] = []
    crs = 0
    drains = 0
    iterations = 0
    remaining = stop

    while remaining > 0:
        iterations += 1
        entry = table.load(sorted_mask)
        if entry is not None:
            alive = entry.mask & ~sorted_mask
            start = entry.sig - 1
            fresh = False
        else:
            alive = ~sorted_mask
            start = s_top
            fresh = True

        seen_mixed = False
        for sig in range(start, -1, -1):
            crs += 1
            if mem.mixed(sig, alive):
                alive = mem.exclude(sig, alive)
                if fresh:
                    if not seen_mixed:
                        # certify columns above `sig` uniform for all
                        # subsets of the current unsorted set
                        s_top = sig
                        seen_mixed = True
                    table.record(sig, alive)

        rows = np.flatnonzero(alive)
        m = len(rows)
        assert m >= 1, "min search lost all rows — algorithm bug"
        # early exit: only the still-needed duplicates leave the row
        # processor (survivors of a full traversal are all equal, so any
        # prefix of them in row order is a correct k-min prefix)
        m = min(m, remaining)
        rows = rows[:m]
        # duplicates drain one per cycle while the column processor stalls
        drains += m - 1
        for r in rows:
            order.append(int(r))
        sorted_mask[rows] = True
        remaining -= m

    order_arr = np.asarray(order, dtype=np.int64)
    vals = np.asarray(values, dtype=np.uint64)[order_arr]
    return SortResult(
        order=order_arr,
        values=vals,
        cycles=crs + drains,
        column_reads=crs,
        drains=drains,
        iterations=iterations,
        meta={"algo": "colskip", "w": w, "k": k, "stop_after": stop},
    )
