"""Typed request/response API for the sort service.

Every payload is mapped at ingress into the order-preserving sortable-uint32
domain (:func:`encode_payload`, the numpy mirror of
:func:`repro_torch.core.topk.to_sortable_uint` — exact equality is asserted in
tests/test_torch_core.py).  Working in one unsigned domain means a single
sentinel value per operation direction pads every dtype correctly, every
backend sorts plain uint32 columns (exactly what the memristive array
stores), and responses decode losslessly back to the request dtype.

Tie-break contract (shared by all backends and the numpy oracle):

  * ``sort`` / ``argsort`` / ``kmin`` — ascending, equal values ordered by
    ascending original index (stable),
  * ``topk`` — descending, equal values ordered by ascending original index
    (the ``lax.top_k`` semantics of the reference package).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "OP_KINDS",
    "SortRequest",
    "SortResponse",
    "decode_values",
    "encode_payload",
]

OP_KINDS = ("sort", "argsort", "topk", "kmin")
_K_OPS = ("topk", "kmin")

_SUPPORTED_DTYPES = ("uint32", "int32", "float32", "float16")
_req_counter = itertools.count()


def encode_payload(x: np.ndarray) -> np.ndarray:
    """Order-preserving map into uint32; numpy mirror of ``to_sortable_uint``.

    float: flip all bits of negatives, flip the sign bit of non-negatives;
    int32: offset by 2^31; uint32: identity.  float16 is widened to float32
    first (exact), so its round trip is lossless too.
    """
    x = np.asarray(x)
    if x.dtype == np.uint32:
        return x
    if x.dtype == np.int32:
        return x.view(np.uint32) ^ np.uint32(0x80000000)
    if x.dtype == np.float16:
        x = x.astype(np.float32)
    if x.dtype != np.float32:
        raise TypeError(f"unsupported payload dtype {x.dtype}")
    b = x.view(np.uint32)
    mask = np.where(b >> 31 == 1, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))
    return b ^ mask


def decode_values(u: np.ndarray, dtype) -> np.ndarray:
    """Inverse of :func:`encode_payload`."""
    dtype = np.dtype(dtype)
    u = np.asarray(u, dtype=np.uint32)
    if dtype == np.uint32:
        return u
    if dtype == np.int32:
        return (u ^ np.uint32(0x80000000)).view(np.int32)
    mask = np.where(u >> 31 == 1, np.uint32(0x80000000), np.uint32(0xFFFFFFFF))
    f = (u ^ mask).view(np.float32)
    return f.astype(dtype) if dtype != np.float32 else f


@dataclass(frozen=True)
class SortRequest:
    """One sort-service request over a 1-D payload of arbitrary length."""

    op: str
    payload: np.ndarray
    k: int | None = None            # required for topk / kmin
    backend: str | None = None      # optional routing hint, else cost policy
    request_id: int = field(default_factory=lambda: next(_req_counter))

    def __post_init__(self):
        if self.op not in OP_KINDS:
            raise ValueError(f"op={self.op!r} not in {OP_KINDS}")
        p = np.asarray(self.payload)
        if p.ndim != 1 or p.size == 0:
            raise ValueError(f"payload must be non-empty 1-D, got shape {p.shape}")
        if p.dtype.name not in _SUPPORTED_DTYPES:
            raise TypeError(
                f"payload dtype {p.dtype} not in {_SUPPORTED_DTYPES}")
        object.__setattr__(self, "payload", p)
        if self.op in _K_OPS:
            if self.k is None or not 1 <= int(self.k) <= p.size:
                raise ValueError(
                    f"{self.op} needs 1 <= k <= len(payload)={p.size}, got {self.k}")
            object.__setattr__(self, "k", int(self.k))
        elif self.k is not None:
            raise ValueError(f"op={self.op!r} takes no k")

    @property
    def n(self) -> int:
        return int(self.payload.size)

    @property
    def out_len(self) -> int:
        """Number of output elements (k for selection ops, N otherwise)."""
        return self.k if self.op in _K_OPS else self.n


@dataclass
class SortResponse:
    """Result + per-request telemetry for one served request."""

    request_id: int
    op: str
    values: np.ndarray | None       # request-dtype domain (None for argsort)
    indices: np.ndarray | None      # original-payload positions
    backend: str
    bucket_shape: tuple[int, int]   # (B, N) tile the request rode in
    latency_s: float
    column_reads: int | None        # exact CRs (colskip) / plane reads (radix)
    cycles: int | None              # exact HW cycles when the backend models them
    meta: dict = field(default_factory=dict)
