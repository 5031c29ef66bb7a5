"""Plain torch version of the colskip sort kernel (the lane-packed §III
machine), batched over rows.

It mirrors the reference's ``_machine_packed`` with ``fuse=1``
(``repro/kernels/colskip/kernel.py``: ``load`` at :171-185, the plane
traversal ``_traverse_planes`` at :111-153, the drain at :194-211) and the
epilogue of ``_sort_kernel`` (:294-310).  Masks travel as packed words
(:mod:`repro_torch.core.bitmatrix`, ``int64`` carriers).  The tests hold
it against the Pallas kernel in interpret mode; the wrapper in ``ops.py``
takes it for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel
against it on the card.

Two shortcuts leave every output unchanged:

  * the traversal visits only planes at or below the highest row's start
    (a plane above a row's start is inactive for it: no CR, no state
    change);
  * the outer loop stops once every row has drained ``stop`` elements (a
    finished row's later iterations change neither outputs nor counters).
"""

from __future__ import annotations

import torch

from repro_torch.core.bitmatrix import (
    WORD_MASK,
    as_words,
    cumsum_bits,
    pack_planes,
    pack_rows,
    popcount,
    tail_mask,
    to_uint32,
    unpack_rows,
)


def sort_ref(x: torch.Tensor, w: int = 32, k: int = 2,
             stop_after: int | None = None):
    """``(B, N)`` 32-bit words -> ``(values, order, column_reads, cycles)``.

    ``values`` ``(B, stop)`` uint32, ``order`` ``(B, stop)`` int32, the
    per-row CR and cycle counts ``(B,)`` int32 (cycles = CRs + drains).
    ``x`` may be uint32, int32 (bit patterns) or an int64 carrier."""
    if not 1 <= w <= 32:
        raise ValueError(f"w={w} out of range [1, 32]")
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    b, n = x.shape
    stop = n if stop_after is None else min(int(stop_after), n)
    if stop < 1:
        raise ValueError(f"stop_after={stop_after} must be >= 1")
    dev = x.device
    u = as_words(x)
    kk = max(1, k)
    planes = pack_planes(u, w)                        # (w, B, W)
    nw = planes.shape[-1]
    valid_w = tail_mask(n, dev)
    i64 = dict(dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)

    sorted_w = torch.zeros((b, nw), **i64)
    sigs = torch.zeros((b, kk), **i64)
    masks = torch.zeros((b, kk, nw), **i64)
    valid = torch.zeros((b, kk), dtype=torch.bool, device=dev)
    s_top = torch.full((b,), w - 1, **i64)
    out_pos = torch.zeros((b, n), **i64)
    count = torch.zeros((b,), **i64)
    crs = torch.zeros((b,), **i64)
    drains = torch.zeros((b,), **i64)
    idx = torch.arange(kk, device=dev)[None, :]

    for _ in range(stop):
        done = count >= stop
        if bool(done.all()):
            break
        # --- load: newest live table entry, else a fresh search at s_top
        unsorted = (sorted_w ^ WORD_MASK) & valid_w
        hit = ((masks & unsorted[:, None, :]) != 0).any(-1)
        live = valid & hit
        exists = live.any(-1)
        first = torch.argmax(live.to(torch.int64), -1)
        valid = torch.where(exists[:, None], valid & (idx >= first[:, None]),
                            torch.zeros_like(valid))
        sel = masks[rows, first]
        alive = torch.where(exists[:, None], sel & unsorted, unsorted)
        start = torch.where(exists, sigs[rows, first] - 1, s_top)
        fresh = ~exists
        # --- traverse planes start..0 (one CR each)
        seen = torch.zeros((b,), dtype=torch.bool, device=dev)
        crs2 = torch.clamp(start + 1, min=0)
        for sig in range(int(start.max()), -1, -1):
            col = planes[sig]
            p1 = ((col & alive) != 0).any(-1)
            p0 = (((col ^ WORD_MASK) & alive) != 0).any(-1)
            mixed = (sig <= start) & p1 & p0
            new_alive = torch.where(mixed[:, None], alive & (col ^ WORD_MASK),
                                    alive)
            rec = mixed & fresh
            if k > 0 and bool(rec.any()):
                # push (sig, mask): the table shifts toward older slots
                sigs = torch.where(rec[:, None], torch.cat(
                    [torch.full((b, 1), sig, **i64), sigs[:, :-1]], 1), sigs)
                masks = torch.where(rec[:, None, None], torch.cat(
                    [new_alive[:, None, :], masks[:, :-1]], 1), masks)
                valid = torch.where(rec[:, None], torch.cat(
                    [torch.ones((b, 1), dtype=torch.bool, device=dev),
                     valid[:, :-1]], 1), valid)
            s_top = torch.where(rec & ~seen, torch.full_like(s_top, sig),
                                s_top)
            seen = seen | rec
            alive = new_alive
        # --- drain the survivors (finished rows drain nothing)
        alive = torch.where(done[:, None], torch.zeros_like(alive), alive)
        crs = crs + torch.where(done, 0, crs2)
        m_tot = popcount(alive).sum(-1)
        m_eff = torch.minimum(m_tot, stop - count)
        rank = cumsum_bits(alive, n) - 1
        keep = unpack_rows(alive, n) & (rank < m_eff[:, None])
        out_pos = torch.where(keep, count[:, None] + rank, out_pos)
        sorted_w = sorted_w | pack_rows(keep)
        count = count + m_eff
        drains = drains + torch.clamp(m_eff - 1, min=0)

    # --- epilogue: order[pos] = column; undrained columns are dropped
    sorted_mask = unpack_rows(sorted_w, n)
    pos = torch.where(sorted_mask, out_pos, stop)
    order = torch.zeros((b, stop + 1), **i64)
    cols = torch.arange(n, device=dev).expand(b, n)
    order.scatter_(1, pos, cols)
    order = order[:, :stop]
    vals = torch.gather(u, 1, order)
    return (to_uint32(vals), order.to(torch.int32),
            crs.to(torch.int32), (crs + drains).to(torch.int32))
