"""Packed bit substrate of the §III machine, on torch tensors.

The torch counterpart of :mod:`repro.core.bitmatrix`.  A ``(…, N)`` boolean
mask is stored as ``(…, ceil(N/32))`` 32-bit words: element ``j`` lives in
bit ``j % 32`` (LSB-first) of word ``j // 32`` and the tail bits past ``N``
are always zero, so bitwise AND/OR/ANDNOT on words are exact set
operations on the masks.

Torch's ``uint32`` lacks shifts, ``~``, ordering and gather/scatter, so the
plain versions carry each word as ``int64`` holding 0..2**32-1; the
complement of a word is ``w ^ 0xFFFFFFFF``.  The CUDA kernels use native
``uint32`` words in the same layout (``__ballot_sync`` builds them).

The numpy :class:`BitMatrix` (with :func:`to_bits` / :func:`from_bits`)
is copied unchanged: the numpy hardware models in :mod:`.colskip` and
:mod:`.baseline18` run on it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "BitMatrix",
    "LANE",
    "WORD_MASK",
    "any_lane",
    "as_words",
    "cumsum_bits",
    "from_bits",
    "pack_planes",
    "pack_rows",
    "packed_words",
    "popcount",
    "tail_mask",
    "to_bits",
    "to_uint32",
    "unpack_rows",
]

LANE = 32                      # bits per packed word (one uint32 column read)
WORD_MASK = 0xFFFFFFFF         # all 32 bits of a word; ``w ^ WORD_MASK`` is ~w


def as_words(x: torch.Tensor) -> torch.Tensor:
    """32-bit words (uint32, int32 bit patterns or an int64 carrier) as the
    ``int64`` carrier.  uint32 goes through an int32 view: the conversion
    kernels of torch's barebones uint32 are not relied on."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & WORD_MASK


def to_uint32(c: torch.Tensor) -> torch.Tensor:
    """``int64`` carrier -> uint32 tensor (through an int32 bit pattern)."""
    return (c & WORD_MASK).to(torch.int32).view(torch.uint32)


def packed_words(n: int) -> int:
    """Words needed to hold ``n`` mask bits."""
    return -(-int(n) // LANE)


def _shifts(device) -> torch.Tensor:
    return torch.arange(LANE, dtype=torch.int64, device=device)


def pack_rows(bits: torch.Tensor) -> torch.Tensor:
    """``(…, N) bool`` -> ``(…, ceil(N/32)) int64`` words; tail bits zero."""
    n = bits.shape[-1]
    nw = packed_words(n)
    b = bits.to(torch.int64)
    if nw * LANE != n:
        b = torch.nn.functional.pad(b, (0, nw * LANE - n))
    b = b.reshape(b.shape[:-1] + (nw, LANE))
    return (b << _shifts(bits.device)).sum(-1)


def unpack_rows(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_rows` — ``(…, W)`` words -> ``(…, n) bool``."""
    bits = (words[..., None] >> _shifts(words.device)) & 1
    return bits.reshape(words.shape[:-1] + (words.shape[-1] * LANE,))[
        ..., :n].to(torch.bool)


def pack_planes(u: torch.Tensor, w: int) -> torch.Tensor:
    """Pre-pack a value array's bit planes: ``(…, N) -> (w, …, W)``.

    ``planes[sig]`` holds bit ``sig`` of every element, packed 32 per word,
    so a column read (CR) is a word fetch."""
    sigs = torch.arange(w, dtype=torch.int64, device=u.device)
    sigs = sigs.reshape((w,) + (1,) * u.ndim)
    return pack_rows(((as_words(u)[None] >> sigs) & 1).to(torch.bool))


def tail_mask(n: int, device="cpu") -> torch.Tensor:
    """``(ceil(n/32),) int64`` words with exactly the ``n`` valid bits set."""
    return pack_rows(torch.ones((n,), dtype=torch.bool, device=device))


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count of 32-bit words (SWAR), shape-preserving."""
    x = as_words(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def any_lane(words: torch.Tensor) -> torch.Tensor:
    """OR-reduce the trailing word axis: True where any mask bit is set."""
    return (words != 0).any(-1)


def cumsum_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inclusive per-element rank of the set bits: ``(…, W) -> (…, n)``.

    The rank of bit ``b`` of word ``i`` is the exclusive prefix of per-word
    popcounts up to word ``i`` plus the popcount of word ``i`` masked to
    bits ``0..b`` — the in-lane scan of the reference."""
    counts = popcount(words)
    prefix = torch.cumsum(counts, -1) - counts
    below = WORD_MASK >> (LANE - 1 - _shifts(words.device))   # bits 0..b set
    inword = popcount(words[..., None] & below)
    rank = prefix[..., None] + inword
    return rank.reshape(words.shape[:-1] + (words.shape[-1] * LANE,))[..., :n]


def to_bits(values: np.ndarray, w: int) -> np.ndarray:
    """Pack ``values`` (uint) into a bool matrix ``[N, w]``, MSB first."""
    v = np.asarray(values, dtype=np.uint64)
    if w < 64 and np.any(v >= (np.uint64(1) << np.uint64(w))):
        raise ValueError(f"values do not fit in {w} bits")
    shifts = np.arange(w - 1, -1, -1, dtype=np.uint64)  # MSB..LSB
    return ((v[:, None] >> shifts[None, :]) & np.uint64(1)).astype(bool)


def from_bits(bits: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_bits` — returns uint64 values."""
    n, w = bits.shape
    shifts = np.arange(w - 1, -1, -1, dtype=np.uint64)
    return (bits.astype(np.uint64) << shifts[None, :]).sum(axis=1, dtype=np.uint64)


class BitMatrix:
    """1T1R crossbar holding the array under sort, with CR/RE primitives."""

    def __init__(self, values: np.ndarray, w: int):
        self.w = int(w)
        self.n = int(len(values))
        self.bits = to_bits(values, w)  # [N, w]; column j==0 is the MSB

    # Column index convention used throughout the simulators: *significance*
    # index i in [0, w-1], where i = w-1 is the MSB (paper's i counts down
    # from MSB to LSB).  Internally column w-1-i of ``self.bits``.

    def column(self, sig: int) -> np.ndarray:
        """CR: the full bit column at significance ``sig`` (bool[N])."""
        return self.bits[:, self.w - 1 - sig]

    def read(self, sig: int, alive: np.ndarray) -> np.ndarray:
        """CR restricted to surviving rows — what the sense amps observe."""
        return self.column(sig) & alive

    def mixed(self, sig: int, alive: np.ndarray) -> bool:
        """True iff the column has both 0s and 1s among surviving rows."""
        col = self.column(sig)[alive]
        return bool(col.any()) and not bool(col.all())

    def exclude(self, sig: int, alive: np.ndarray) -> np.ndarray:
        """RE: drop surviving rows whose bit is 1 (the non-minima)."""
        return alive & ~self.column(sig)
