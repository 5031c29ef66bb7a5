"""Plain torch versions of the colskip sort kernel (the §III machine),
batched over rows, on both mask carriers.

``packed=True`` mirrors the reference's ``_machine_packed`` and
``packed=False`` its ``_machine_dense``
(``repro/kernels/colskip/kernel.py``: the packed ``load`` at :171-185 and
the dense one at :235-249, the shared plane traversal
``_traverse_planes`` at :92-160, the drains at :194-211 and :259-276) and
the epilogue of ``_sort_kernel`` (:294-310).  As in the reference, one
machine body serves both carriers; they differ only in how a mask is
held and read (:class:`_Packed`, :class:`_Dense`).  The packed carrier's
masks are packed words (:mod:`repro_torch.core.bitmatrix`, ``int64``
carriers); the dense carrier's are ``(B, N)`` bool, a column read is
``(x >> sig) & 1`` on the ``int64``-carried words and the drain rank is a
``cumsum`` in element order.  The tests hold both against the Pallas
kernel in interpret mode; the wrapper in ``ops.py`` takes them for CPU
tensors, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.

``fuse=F`` walks the planes in blocks of F under the speculative tree of
``_traverse_planes``: each block computes every plane's saw-a-1 / saw-a-0
pair under each of the ``2^i`` hypotheses of its earlier planes' verdicts
(``2 * (2^F - 1)`` predicates, one OR round), then resolves the verdicts
plane by plane.  The packed CUDA kernel encodes the same speculation as
the set of F-bit patterns its alive elements show (``colskip.cu``), with
the same blocks and the same verdicts.  Blocks are aligned at multiples
of F (planes ``bF + F - 1 .. bF``), as in the kernel, where the
reference aligns them at ``w - 1``; a plane above a row's start is
inactive either way, so the outputs are the same for any F and either
alignment.

Three shortcuts leave every output unchanged:

  * the traversal visits only blocks at or below the highest row's start
    (a plane above a row's start is inactive for it: no CR, no state
    change);
  * a ghost plane above ``w - 1`` in the top block reads plane ``w - 1``
    (it is above every start, so never active);
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


class _Packed:
    """Masks as ``(B, ceil(N/32))`` packed words; a CR fetches one plane."""

    def __init__(self, u: torch.Tensor, w: int):
        self.n = u.shape[1]
        self.planes = pack_planes(u, w)               # (w, B, W)
        self.width = self.planes.shape[-1]
        self.valid = tail_mask(self.n, u.device)

    def empty(self, *lead) -> torch.Tensor:
        return torch.zeros(lead + (self.width,), dtype=torch.int64,
                           device=self.valid.device)

    def unsorted(self, sorted_m):
        return (sorted_m ^ WORD_MASK) & self.valid

    def any(self, m):
        return (m != 0).any(-1)

    def col(self, sig: int):
        return self.planes[sig]

    def zeros_of(self, col, m):                       # alive & ~col
        return m & (col ^ WORD_MASK)

    def count(self, m):
        return popcount(m).sum(-1)

    def rank(self, m):                                # 0-based, (B, N)
        return cumsum_bits(m, self.n) - 1

    def bits(self, m):
        return unpack_rows(m, self.n)

    def pack(self, bits):
        return pack_rows(bits)


class _Dense:
    """Masks as ``(B, N)`` bool; a CR shifts the words of the tile."""

    def __init__(self, u: torch.Tensor, w: int):
        self.u = u
        self.width = u.shape[1]

    def empty(self, *lead) -> torch.Tensor:
        return torch.zeros(lead + (self.width,), dtype=torch.bool,
                           device=self.u.device)

    def unsorted(self, sorted_m):
        return ~sorted_m

    def any(self, m):
        return m.any(-1)

    def col(self, sig: int):
        return ((self.u >> sig) & 1).to(torch.bool)

    def zeros_of(self, col, m):
        return m & ~col

    def count(self, m):
        return m.sum(-1)

    def rank(self, m):
        return torch.cumsum(m.to(torch.int64), -1) - 1

    def bits(self, m):
        return m

    def pack(self, bits):
        return bits


def colskip_machine(u: torch.Tensor, w: int, k: int, stop: int, *,
                    or_any=None, drain_counts=None, packed: bool = True,
                    fuse: int = 1):
    """Batched §III state machine over the bank gates: the reference's
    ``colskip_machine`` (``repro/kernels/colskip/kernel.py:54-90``).

    ``u`` is one bank's ``(B, N_local)`` column shard of 32-bit words (the
    whole tile when run as one bank; a bank-stacked tile for the plain
    mesh, :func:`sort_mesh_ref`).  The two multi-bank-manager combine
    points are injectable, with the reference's contract:

      * ``or_any(bits)`` ORs the per-row predicate stacks across banks,
        ``(B, P)`` bool -> ``(B, P)`` bool: a fused block's saw-a-1 /
        saw-a-0 pairs (one call a block) and the SL gate's per-entry hit
        bits (one call a load); identity for one bank;
      * ``drain_counts(m_local) -> (m_total, before)``: the global survivor
        count and this bank's exclusive bank-major prefix; ``(m, 0)`` for
        one bank.

    Returns ``(sorted_mask (B, N_local) bool, out_pos (B, N_local) int64,
    crs (B,) int64, drains (B,) int64)``; callers assemble values and
    order from them.  ``stop`` is the number of elements to drain (at most
    the row's global width)."""
    if not 1 <= w <= 32:
        raise ValueError(f"w={w} out of range [1, 32]")
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    if not 1 <= fuse <= 8:
        raise ValueError(f"fuse={fuse} out of range [1, 8]")
    gated = or_any is not None
    if or_any is None:
        or_any = lambda bits: bits                      # noqa: E731
    if drain_counts is None:
        drain_counts = lambda m: (m, torch.zeros_like(m))   # noqa: E731
    b, n = u.shape
    dev = u.device
    kk = max(1, k)
    cm = (_Packed if packed else _Dense)(u, w)
    i64 = dict(dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)

    sorted_m = cm.empty(b)
    sigs = torch.zeros((b, kk), **i64)
    masks = cm.empty(b, kk)
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
        # (the SL gate: a table entry is live when some bank still holds
        # one of its elements unsorted)
        unsorted = cm.unsorted(sorted_m)
        hit = cm.any(masks & unsorted[:, None, :])
        live = valid & or_any(hit)
        exists = live.any(-1)
        first = torch.argmax(live.to(torch.int64), -1)
        valid = torch.where(exists[:, None], valid & (idx >= first[:, None]),
                            torch.zeros_like(valid))
        sel = masks[rows, first]
        alive = torch.where(exists[:, None], sel & unsorted, unsorted)
        start = torch.where(exists, sigs[rows, first] - 1, s_top)
        fresh = ~exists
        # --- traverse planes start..0 (one CR each) in blocks of `fuse`
        seen = torch.zeros((b,), dtype=torch.bool, device=dev)
        crs2 = torch.clamp(start + 1, min=0)
        top = int(start.max())
        for base in range(top - top % fuse, -1, -fuse) if top >= 0 else ():
            # block planes base+fuse-1 .. base; a plane above w-1 (the
            # top block's ghost) fetches plane w-1 and is never active
            sigs_b = [base + fuse - 1 - i for i in range(fuse)]
            cols = [cm.col(min(s, w - 1)) for s in sigs_b]
            # speculative tree: hypothesis h (bit j set: plane j of the
            # block mixed) feeds plane i's saw-a-1 / saw-a-0 pair at
            # bits 2*(2^i - 1) + 2*h and one more
            hyps, pairs = [alive], []
            for i in range(fuse):
                for h in hyps:
                    pairs.append(cm.any(cols[i] & h))
                    pairs.append(cm.any(cm.zeros_of(cols[i], h)))
                if i + 1 < fuse:
                    hyps = hyps + [cm.zeros_of(cols[i], h) for h in hyps]
            # one manager round a block: every pair of the tree
            verdicts = (or_any(torch.stack(pairs, -1))
                        if gated or fuse > 1 else None)
            branch = torch.zeros((b,), **i64)
            for i, sig in enumerate(sigs_b):
                if verdicts is None:                   # one hypothesis
                    p1, p0 = pairs[0], pairs[1]
                else:
                    at = (2 * ((1 << i) - 1) + 2 * branch)[:, None]
                    p1 = torch.gather(verdicts, 1, at)[:, 0]
                    p0 = torch.gather(verdicts, 1, at + 1)[:, 0]
                mixed = (sig <= start) & p1 & p0
                branch = branch | (mixed.to(torch.int64) << i)
                new_alive = torch.where(mixed[:, None],
                                        cm.zeros_of(cols[i], alive), alive)
                rec = mixed & fresh
                if k > 0 and bool(rec.any()):
                    # push (sig, mask): the table shifts toward older slots
                    sigs = torch.where(rec[:, None], torch.cat(
                        [torch.full((b, 1), sig, **i64), sigs[:, :-1]], 1),
                        sigs)
                    masks = torch.where(rec[:, None, None], torch.cat(
                        [new_alive[:, None, :], masks[:, :-1]], 1), masks)
                    valid = torch.where(rec[:, None], torch.cat(
                        [torch.ones((b, 1), dtype=torch.bool, device=dev),
                         valid[:, :-1]], 1), valid)
                s_top = torch.where(rec & ~seen, torch.full_like(s_top, sig),
                                    s_top)
                seen = seen | rec
                alive = new_alive
        # --- drain the survivors (finished rows drain nothing), bank-major
        # with the k-early exit: only the still-needed elements
        alive = torch.where(done[:, None], torch.zeros_like(alive), alive)
        crs = crs + torch.where(done, 0, crs2)
        m_tot, before = drain_counts(cm.count(alive))
        m_eff = torch.minimum(m_tot, stop - count)
        rank = before[:, None] + cm.rank(alive)
        keep = cm.bits(alive) & (rank < m_eff[:, None])
        out_pos = torch.where(keep, count[:, None] + rank, out_pos)
        sorted_m = sorted_m | cm.pack(keep)
        count = count + m_eff
        drains = drains + torch.clamp(m_eff - 1, min=0)
    return cm.bits(sorted_m), out_pos, crs, drains


def sort_ref(x: torch.Tensor, w: int = 32, k: int = 2,
             stop_after: int | None = None, packed: bool = True,
             fuse: int = 1):
    """``(B, N)`` 32-bit words -> ``(values, order, column_reads, cycles)``.

    ``values`` ``(B, stop)`` uint32, ``order`` ``(B, stop)`` int32, the
    per-row CR and cycle counts ``(B,)`` int32 (cycles = CRs + drains).
    ``x`` may be uint32, int32 (bit patterns) or an int64 carrier.
    ``packed`` picks the mask carrier and ``fuse`` the planes walked per
    verdict round (the speculative tree); the outputs depend on neither."""
    b, n = x.shape
    stop = n if stop_after is None else min(int(stop_after), n)
    if stop < 1:
        raise ValueError(f"stop_after={stop_after} must be >= 1")
    u = as_words(x)
    sorted_mask, out_pos, crs, drains = colskip_machine(
        u, w, k, stop, packed=packed, fuse=fuse)
    # --- epilogue: order[pos] = column; undrained columns are dropped
    dev = u.device
    pos = torch.where(sorted_mask, out_pos, stop)
    order = torch.zeros((b, stop + 1), dtype=torch.int64, device=dev)
    cols = torch.arange(n, device=dev).expand(b, n)
    order.scatter_(1, pos, cols)
    order = order[:, :stop]
    vals = torch.gather(u, 1, order)
    return (to_uint32(vals), order.to(torch.int32),
            crs.to(torch.int32), (crs + drains).to(torch.int32))


def bank_hooks(banks: int):
    """The manager gates of a tile stacked bank-major as ``(banks * B, ...)``
    rows (bank ``d``'s shard of row ``r`` at row ``d * B + r``): ``or_any``
    ORs each row's predicates over the banks and gives every bank the
    result; ``drain_counts`` gives every bank the row's survivor total and
    its exclusive bank-major prefix.  The plain realization of the
    reference's ``psum`` / ``all_gather`` gates
    (``repro/dist/bankmesh.py:143-158``)."""

    def or_any(bits):
        stacked = bits.reshape(banks, -1, *bits.shape[1:])
        return stacked.any(0).repeat(banks, *([1] * (bits.dim() - 1)))

    def drain_counts(m):
        per = m.reshape(banks, -1)
        before = torch.cumsum(per, 0) - per
        return per.sum(0).repeat(banks), before.reshape(-1)

    return or_any, drain_counts


def sort_mesh_ref(x: torch.Tensor, banks: int, w: int = 32, k: int = 2,
                  stop_after: int | None = None, packed: bool = True,
                  fuse: int = 1):
    """The plain mesh: the rows of ``x`` ``(B, N)`` split into ``banks``
    contiguous column shards of ``N / banks``, each a bank of the §IV
    manager, through :func:`colskip_machine` with :func:`bank_hooks`.
    Returns :func:`sort_ref`'s outputs, assembled as the reference's
    ``_colskip_tile_local`` assembles them (``bankmesh.py:168-179``): each
    bank places its drained elements at their global positions, with
    columns in global numbering ``bank * N / banks + j``."""
    b, n = x.shape
    if banks < 1 or n % banks:
        raise ValueError(f"N={n} not divisible over {banks} mesh banks")
    stop = n if stop_after is None else min(int(stop_after), n)
    if stop < 1:
        raise ValueError(f"stop_after={stop_after} must be >= 1")
    u = as_words(x)
    n_loc = n // banks
    shards = u.reshape(b, banks, n_loc).transpose(0, 1).reshape(-1, n_loc)
    or_any, drain_counts = bank_hooks(banks)
    sorted_mask, out_pos, crs, drains = colskip_machine(
        shards, w, k, stop, or_any=or_any, drain_counts=drain_counts,
        packed=packed, fuse=fuse)
    dev = u.device
    # every bank scatters its drained elements into the global result
    pos = torch.where(sorted_mask, out_pos, stop).reshape(banks, b, n_loc)
    pos = pos.transpose(0, 1).reshape(b, n)
    order = torch.zeros((b, stop + 1), dtype=torch.int64, device=dev)
    order.scatter_(1, pos, torch.arange(n, device=dev).expand(b, n))
    order = order[:, :stop]
    vals = torch.gather(u, 1, order)
    crs, drains = crs[:b], drains[:b]          # every bank holds the same
    return (to_uint32(vals), order.to(torch.int32),
            crs.to(torch.int32), (crs + drains).to(torch.int32))
