"""The card's peaks and the work a kernel's inputs need.

Peaks of one NVIDIA H100 SXM at its 700 W limit: HBM3 at 3.35 TB/s (data
sheet).  The data sheet gives no plain 32-bit integer rate; the one used
here is derived: 132 SMs x 64 int32 lanes x 1.98 GHz boost clock =
16.73 TOP/s.  A share of the roofline is the least time, the larger of
bytes over bandwidth and operations over the operation rate, over the
device time the kernels took.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
WORD_BITS = 32


def least_time_s(ops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def colskip_row_work(width: int, reads: int, out: int,
                     mesh: bool = False) -> tuple[int, int]:
    """``(word operations, bytes)`` of one row of the column-skipping
    machine: each column read is one operation on each of the row's
    ``ceil(width / 32)`` mask words; the row's keys are read once and
    its ``out`` values and positions written once, with its reads and
    cycles (and, on the mesh, its exchange rounds) as 32-bit counts."""
    words = -(-int(width) // WORD_BITS)
    nbytes = 4 * width + 8 * out + 8 + (4 if mesh else 0)
    return int(reads) * words, nbytes


def radix_tile_bytes(rows: int, width: int, k: int) -> int:
    """Bytes of one radix top-k launch: the tile's keys read once, each
    row's k values, k positions and plane reads written once."""
    return 4 * rows * width + 4 * rows * (2 * k + 1)


def share_pct(least_s: float, device_s: float | None) -> float | None:
    """100 x least time / device time; None without device time."""
    if not device_s or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
