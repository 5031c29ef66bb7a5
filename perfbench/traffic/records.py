"""What a window keeps of each request and response.

Inside the window a response is kept as a plain tuple of a string, arrays
and numbers (:func:`keep`), which the collector untracks, so the run's
records do not lengthen the interpreter's full collections (which pause
the service) as the window goes on.  After the window they become the
named records below, which the reference and the metric readers read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Req(NamedTuple):
    op: str
    payload: np.ndarray
    k: int | None
    n: int
    request_id: int


class Resp(NamedTuple):
    backend: str
    values: np.ndarray | None
    indices: np.ndarray | None
    column_reads: int | None
    cycles: int | None


def keep(resp) -> tuple:
    """The parts of a ``SortResponse`` the reference judges, as a plain
    tuple (:class:`Resp`'s fields)."""
    return (resp.backend, resp.values, resp.indices, resp.column_reads,
            resp.cycles)


def responses(kept: list) -> list:
    """:func:`keep`'s tuples (or None) as :class:`Resp` records."""
    return [None if t is None else Resp(*t) for t in kept]
