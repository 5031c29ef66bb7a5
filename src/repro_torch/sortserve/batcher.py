"""Shape bucketing: heterogeneous requests -> fixed ``(B, N)`` uint32 tiles.

Requests are grouped by ``(op, pow2(N), pow2(k))``; each group is coalesced
into tiles of exactly ``tile_rows`` rows.  ``k`` is rounded up to a power of
two just like the width — a tile selects ``pow2(k)`` elements and each
request keeps its exact first ``k`` of them (valid because the k'-min /
top-k' prefix of any k' >= k is the k-min / top-k) — otherwise every
distinct ``k`` in the stream would mint a fresh launcher signature.  Column
padding (to the pow-2 bucket width) and row padding (to the fixed tile
height) use sentinels in the sortable-uint32 domain:

  * ascending ops (sort / argsort / kmin) pad with ``0xFFFFFFFF`` — the
    domain maximum, so padding always sorts *after* every real element and
    the first ``true_len`` outputs of a row are exactly the request's answer;
  * ``topk`` pads with ``0x00000000`` — the domain minimum, which can tie
    with a real element but never precede it under the ascending-index
    tie-break (real rows sit at lower column indices than padding).

Keeping the tile menu small and fixed is what keeps the backends' kernel
launcher caches warm: every distinct ``(op, B, N, k)`` signature builds its
launcher once and is then a dictionary hit.  The batcher tracks exactly that —
``signature_hits / tiles`` is the bucket hit-rate exported by the engine.

Incremental emission: streaming sessions close buckets on **size or
age**, not only on flush — :meth:`Batcher.take_ready` emits every full tile
immediately and, given a deadline, closes buckets whose oldest request has
waited ``max_age_s``.  Timestamps are caller-supplied (the engine's
injectable clock), so age-based closing is deterministic in tests.  Several
batchers may share one :class:`BatcherStats` (``stats=``): per-session
batchers aggregate into the engine's telemetry without sharing buckets.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from .request import SortRequest, encode_payload

__all__ = ["Batcher", "BatcherStats", "Tile", "pow2_bucket"]

PAD_ASC = np.uint32(0xFFFFFFFF)     # sorts last under ascending ops
PAD_DESC = np.uint32(0x00000000)    # never enters a top-k of real elements


def pow2_bucket(n: int, min_bucket: int = 8) -> int:
    """Smallest power of two >= max(n, min_bucket)."""
    if n <= 0:
        raise ValueError(f"n={n} must be positive")
    return max(min_bucket, 1 << (n - 1).bit_length())


@dataclass
class Tile:
    """A fixed-shape unit of work: ``rows`` requests padded into one array."""

    op: str
    data: np.ndarray                       # (B, N) uint32, sortable domain
    k: int | None                          # static per-tile selection width
    entries: list[tuple[SortRequest, int]]  # (request, row) — row < len(entries)
    pad_rows: int                          # sentinel-only rows at the bottom
    hint: str | None = None                # routing hint shared by all entries
    obs: dict = field(default_factory=dict)  # observability tags (trace seq)

    @property
    def shape(self) -> tuple[int, int]:
        return self.data.shape  # type: ignore[return-value]

    @property
    def signature(self) -> tuple:
        """Jit-cache key: everything static about the compiled computation,
        including where it runs — differently-routed tiles share no cache."""
        b, n = self.data.shape
        return (self.op, b, n, self.k, self.hint)


@dataclass
class BatcherStats:
    tiles: int = 0
    requests: int = 0
    pad_rows: int = 0
    pad_cols: int = 0                      # sentinel elements in real rows
    real_elems: int = 0
    signature_hits: int = 0
    signatures: set = field(default_factory=set)

    @property
    def hit_rate(self) -> float:
        return self.signature_hits / self.tiles if self.tiles else 0.0

    @property
    def pad_col_frac(self) -> float:
        tot = self.pad_cols + self.real_elems
        return self.pad_cols / tot if tot else 0.0


class Batcher:
    """Accumulates requests and emits them as fixed-shape tiles.

    Buckets close three ways: :meth:`flush` closes everything (the batch
    path), :meth:`take_ready` closes full tiles immediately (size) and —
    when given ``now``/``max_age_s`` — buckets whose oldest request has
    aged out (the streaming path)."""

    def __init__(self, tile_rows: int = 8, min_bucket: int = 8, *,
                 stats: BatcherStats | None = None):
        if tile_rows < 1:
            raise ValueError("tile_rows must be >= 1")
        self.tile_rows = tile_rows
        self.min_bucket = min_bucket
        # items are (request, encoded payload, add timestamp); timestamps
        # are None on the batch path and clock readings on the stream path
        self._groups: dict[tuple, list] = defaultdict(list)
        self.stats = stats if stats is not None else BatcherStats()

    def bucket_key(self, req: SortRequest) -> tuple:
        n_pad = pow2_bucket(req.n, self.min_bucket)
        # pow2(k) <= pow2(n) = n_pad since k <= n, so the padded selection
        # width always fits the padded row
        k_pad = pow2_bucket(req.k, 1) if req.k is not None else None
        # the routing hint is part of the key: a hinted request must never
        # share a tile with (and silently re-route) differently-hinted or
        # policy-routed requests
        return (req.op, n_pad, k_pad, req.backend)

    def signature_of(self, req: SortRequest) -> tuple:
        """The launcher signature of the tile this request would join:
        ``(op, tile_rows, pow2(N), pow2(k), hint)`` — identical to
        :attr:`Tile.signature` (tiles are always ``tile_rows`` tall).  The
        engine records these per traffic class so ``begin(traffic_class=…)``
        can prewarm a session's executor menu before any tile runs."""
        op, n_pad, k_pad, hint = self.bucket_key(req)
        return (op, self.tile_rows, n_pad, k_pad, hint)

    def add(self, req: SortRequest, now: float | None = None) -> None:
        """Bucket a request; ``now`` stamps it for age-based closing."""
        self._groups[self.bucket_key(req)].append(
            (req, encode_payload(req.payload), now))

    def pending(self) -> int:
        return sum(len(v) for v in self._groups.values())

    def oldest_deadline(self, max_age_s: float) -> float | None:
        """Earliest instant any open bucket ages out, or None when every
        pending request is unstamped (or nothing is pending)."""
        born = [items[0][2] for items in self._groups.values()
                if items and items[0][2] is not None]
        return min(born) + max_age_s if born else None

    def _emit(self, key: tuple, chunk: list) -> Tile:
        """Close one bucket chunk into a tile (shared by flush/take_ready)."""
        op, n_pad, k, hint = key
        pad = PAD_DESC if op == "topk" else PAD_ASC
        data = np.full((self.tile_rows, n_pad), pad, dtype=np.uint32)
        entries = []
        for row, (req, enc, _) in enumerate(chunk):
            data[row, :req.n] = enc
            entries.append((req, row))
            self.stats.pad_cols += n_pad - req.n
            self.stats.real_elems += req.n
        tile = Tile(op=op, data=data, k=k, entries=entries,
                    pad_rows=self.tile_rows - len(chunk), hint=hint)
        self.stats.tiles += 1
        self.stats.requests += len(chunk)
        self.stats.pad_rows += tile.pad_rows
        if tile.signature in self.stats.signatures:
            self.stats.signature_hits += 1
        else:
            self.stats.signatures.add(tile.signature)
        return tile

    def flush(self) -> list[Tile]:
        """Drain all groups into tiles of exactly ``tile_rows`` rows each."""
        tiles: list[Tile] = []
        for key, items in sorted(self._groups.items(),
                                 key=lambda kv: (kv[0][0], kv[0][1])):
            for i in range(0, len(items), self.tile_rows):
                tiles.append(self._emit(key, items[i:i + self.tile_rows]))
        self._groups.clear()
        return tiles

    def take_ready(self, now: float | None = None,
                   max_age_s: float | None = None) -> list[Tile]:
        """Incremental emission: close buckets on size or age, keep the rest.

        Every group with at least ``tile_rows`` requests emits its full
        tiles immediately (the remainder stays open and keeps its original
        timestamps).  When ``now`` and ``max_age_s`` are given, a group
        whose *oldest* stamped request has waited ``max_age_s`` closes
        completely — the streaming latency bound: no request waits for
        co-batched neighbours longer than the age limit."""
        tiles: list[Tile] = []
        for key in sorted(self._groups, key=lambda kv: (kv[0], kv[1])):
            items = self._groups[key]
            n_full = len(items) // self.tile_rows * self.tile_rows
            for i in range(0, n_full, self.tile_rows):
                tiles.append(self._emit(key, items[i:i + self.tile_rows]))
            rest = items[n_full:]
            aged = (rest and max_age_s is not None and now is not None
                    and rest[0][2] is not None
                    and now - rest[0][2] >= max_age_s)
            if aged:
                tiles.append(self._emit(key, rest))
                rest = []
            if rest:
                self._groups[key] = rest
            else:
                del self._groups[key]
        return tiles
