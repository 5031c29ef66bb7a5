"""Deterministic data pipeline with checkpointable iterator state.

A copy of the reference's ``repro/data/pipeline.py``, which needs numpy
only (the port imports nothing of the reference): the same batches, byte
for byte, for the same seed and step.

``SyntheticCorpus`` produces a reproducible token stream as a pure function
of ``step`` — the iterator's only state is an integer, so checkpoint/restore
and *at-least-once* data visitation under preemption are trivial (the step
counter lives in the training state tree).

``LengthBucketer`` packs variable-length documents into fixed-length training
sequences, ordering documents by length first (host-side numpy).
"""

from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    """Zipf-ish token stream, bimodal doc lengths (chat-like + long-form)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch(self, step: int) -> dict:
        """Pure function of step -> {'tokens': (B, S) int32}."""
        rng = np.random.default_rng((self.seed, step))
        # zipf over a capped vocab for realistic token frequencies
        z = rng.zipf(1.3, size=(self.global_batch, self.seq_len))
        tokens = (z % self.vocab).astype(np.int32)
        return {"tokens": tokens}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class LengthBucketer:
    """Sort documents by length, pack greedily into seq_len-token rows."""

    def __init__(self, seq_len: int, pad_id: int = 0):
        self.seq_len = seq_len
        self.pad_id = pad_id

    def pack(self, docs: list[np.ndarray]) -> np.ndarray:
        lengths = np.asarray([len(d) for d in docs], np.uint64)
        order = np.argsort(lengths, kind="stable")   # radix-sortable keys
        rows, cur = [], []
        used = 0
        for i in order[::-1]:                        # longest first
            d = docs[i][: self.seq_len]
            if used + len(d) > self.seq_len:
                rows.append(self._finish(cur))
                cur, used = [], 0
            cur.append(d)
            used += len(d)
        if cur:
            rows.append(self._finish(cur))
        return np.stack(rows)

    def _finish(self, parts):
        row = np.concatenate(parts) if parts else np.zeros(0, np.int32)
        out = np.full(self.seq_len, self.pad_id, np.int32)
        out[: len(row)] = row[: self.seq_len]
        return out
