"""Plain NumPy reference of what a sort-service response must say.

Written from the paper (arXiv:2202.10424 §III) and the service's request
contract, independent of the program under test: it imports nothing of
it.  A request is answered on its payload mapped into the
order-preserving sortable uint32 domain:

* ``sort``, ``argsort``, ``kmin`` ascending, equal keys by ascending
  position (stable); ``topk`` descending, equal keys by ascending position;
* a row served by the column-skipping machine carries the machine's column
  reads and cycles on the row as the tile holds it: the payload followed
  by sentinels up to the tile's power-of-two width (``0xFFFFFFFF`` for the
  ascending ops);
* a row served by the radix selection carries its plane reads: the bit
  planes that are mixed over the padded row (``0x00000000`` pads ``topk``).

:func:`colskip_reads_plain` is the §III machine column by column, as the
paper describes it; :func:`colskip_reads` computes the same counts from the
row's sorted distinct keys, fast enough to check every served row.
"""

from __future__ import annotations

import numpy as np

PAD_ASC = 0xFFFFFFFF        # sorts after every key
PAD_DESC = 0x00000000       # never precedes a key in a top-k


def encode(x: np.ndarray) -> np.ndarray:
    """Order-preserving map of uint32 / int32 / float32 keys into uint32."""
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return x
    if x.dtype == np.int32:
        return x.view(np.uint32) ^ np.uint32(0x80000000)
    if x.dtype == np.float32:
        b = x.view(np.uint32)
        neg = (b >> np.uint32(31)).astype(bool)
        return np.where(neg, ~b, b | np.uint32(0x80000000)).astype(np.uint32)
    raise TypeError(f"no sortable encoding for {x.dtype}")


def pow2_width(n: int, min_bucket: int) -> int:
    """The tile width a row of ``n`` keys is padded to."""
    return max(int(min_bucket), 1 << (int(n) - 1).bit_length())


def padded_row(u: np.ndarray, op: str, width: int) -> np.ndarray:
    """``u`` followed by the op's sentinel up to ``width``."""
    out = np.full(width, PAD_DESC if op == "topk" else PAD_ASC, np.uint32)
    out[:u.size] = u
    return out


def answer(op: str, u: np.ndarray, k: int | None) -> np.ndarray:
    """Positions a correct response returns, in order (int64)."""
    u = np.asarray(u, np.uint32)
    if op in ("sort", "argsort"):
        return np.argsort(u, kind="stable")
    if op == "kmin":
        return np.argsort(u, kind="stable")[:k]
    if op == "topk":
        return np.argsort(~u, kind="stable")[:k]
    raise ValueError(f"unknown op {op!r}")


def plane_reads(row: np.ndarray) -> int:
    """Bit planes on which the (padded) row holds both a 0 and a 1."""
    row = np.asarray(row, np.uint32)
    mixed = int(np.bitwise_or.reduce(row)) ^ int(np.bitwise_and.reduce(row))
    return bin(mixed).count("1")


def colskip_reads_plain(row: np.ndarray, w: int = 32, k: int = 2,
                        stop: int | None = None) -> tuple[int, int]:
    """The §III machine on one row, column by column: ``(column reads,
    cycles)``.

    A min search walks the columns from its start down to the LSB; at a
    column where the alive rows hold both bits it drops the rows holding a
    1.  A search that starts from the whole unsorted set (fresh) records
    each such column and its surviving rows in a k-entry table, most recent
    first, and certifies the columns above its first such column uniform
    (later fresh searches start there).  A search starts from the most
    recent entry that still holds unsorted rows, one column below it;
    entries with none are dropped.  Survivors of a search are equal keys:
    they leave one a cycle, the first in the search's last column read.
    ``stop`` ends the machine after that many keys have left."""
    row = np.asarray(row, np.uint64)
    n = row.size
    bits = [((row >> np.uint64(s)) & np.uint64(1)).astype(bool)
            for s in range(w)]
    done = np.zeros(n, bool)
    table: list[tuple[int, np.ndarray]] = []
    s_top = w - 1
    reads = drains = 0
    remaining = n if stop is None else min(int(stop), n)
    while remaining > 0:
        entry = None
        while table:
            if (table[0][1] & ~done).any():
                entry = table[0]
                break
            table.pop(0)
        if entry is not None:
            alive, start, fresh = entry[1] & ~done, entry[0] - 1, False
        else:
            alive, start, fresh = ~done, s_top, True
        first = True
        for s in range(start, -1, -1):
            reads += 1
            ones = alive & bits[s]
            if ones.any() and (alive & ~bits[s]).any():
                alive = alive & ~bits[s]
                if fresh:
                    if first:
                        s_top, first = s, False
                    table.insert(0, (s, alive.copy()))
                    del table[k:]
        rows = np.flatnonzero(alive)[:remaining]
        drains += rows.size - 1
        done[rows] = True
        remaining -= rows.size
    return reads, reads + drains


def colskip_reads(row: np.ndarray, w: int = 32, k: int = 2,
                  stop: int | None = None) -> tuple[int, int]:
    """:func:`colskip_reads_plain`'s counts from the row's sorted keys.

    The unsorted set is always the keys from the current minimum m up, so
    a search needs no masks: the columns mixed under it are the highest
    bits where m differs from a larger key, ``msb(m ^ v)``, at or below
    its start, and a table entry (s, m's bits from s up) still holds
    unsorted rows exactly while the current minimum has those bits.  For
    sorted distinct keys d, ``msb(d[t] ^ d[j])`` is the largest of
    ``msb(d[i] ^ d[i+1])`` for t <= i < j, so the mixed set of the search
    at d[t] is the set of running maxima of that sequence from t on."""
    keys, counts = np.unique(np.asarray(row, np.uint64), return_counts=True)
    d = [int(v) for v in keys]
    gaps = [(d[i] ^ d[i + 1]).bit_length() - 1 for i in range(len(d) - 1)]
    # mixed[t]: bit mask of the running maxima of gaps[t:] (next-greater chain)
    mixed = [0] * len(d)
    stack: list[int] = []
    for t in range(len(gaps) - 1, -1, -1):
        while stack and gaps[stack[-1]] <= gaps[t]:
            stack.pop()
        mixed[t] = (1 << gaps[t]) | (mixed[stack[-1]] if stack else 0)
        stack.append(t)
    table: list[tuple[int, int]] = []   # (column, prefix), newest first
    s_top = w - 1
    reads = drains = 0
    remaining = int(counts.sum()) if stop is None else min(int(stop),
                                                           int(counts.sum()))
    t = 0
    while remaining > 0:
        m = d[t]
        while table and (m >> table[0][0]) != table[0][1]:
            table.pop(0)
        fresh = not table
        start = s_top if fresh else table[0][0] - 1
        reads += start + 1
        cols = mixed[t] & ((1 << (start + 1)) - 1)
        if fresh and cols:
            s_top = cols.bit_length() - 1
            low = []
            while cols and len(low) < k:
                bit = cols & -cols
                low.append(bit.bit_length() - 1)
                cols ^= bit
            table = [(s, m >> s) for s in low] + table
            del table[k:]
        taken = min(int(counts[t]), remaining)
        drains += taken - 1
        remaining -= taken
        t += 1
    return reads, reads + drains
