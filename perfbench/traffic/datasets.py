"""Key generators: the paper's §V datasets and the launcher's mixed payloads.

A frozen copy of ``repro_torch.core.datasets`` (uniform, normal, clustered,
kruskal, mapreduce: w-bit unsigned keys, calibrated so the k = 2
column-skipping speed-ups land in the paper's bands) and of the payload
draw of ``repro_torch.launch.sortserve.make_workload`` (uint32 over the
full range, int32 over the full range, float32 normal times 1e3).  Each
generator takes a ``numpy.random.Generator`` and returns ``n`` keys.
"""

from __future__ import annotations

import numpy as np


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
    # two clusters centred at 2^15 and 2^25, sigma = 2^13 (paper §V)
    c1, c2, sd = float(1 << 15), float(1 << 25), float(1 << 13)
    pick = rng.integers(0, 2, size=n).astype(bool)
    vals = np.where(pick, rng.normal(c1, sd, size=n),
                    rng.normal(c2, sd, size=n))
    return _clip(np.rint(vals), w)


def kruskal(rng: np.random.Generator, n: int, w: int = 32) -> np.ndarray:
    """MST edge weights: integer-rounded exponential weights."""
    vals = np.floor(rng.exponential(scale=5000.0, size=n)).astype(np.uint64)
    return _clip(vals, w)


def mapreduce(rng: np.random.Generator, n: int, w: int = 32,
              groups: int = 48, spread: float = 16.0) -> np.ndarray:
    """Map keys in a few Zipf-weighted groups below 2^19 with small
    exponential jitter: heavy repetition and short prefixes."""
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


def dataset(name: str, rng: np.random.Generator, n: int,
            w: int = 32) -> np.ndarray:
    """``n`` keys of a §V dataset as uint32."""
    try:
        fn = DATASETS[name]
    except KeyError:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return fn(rng, n, w).astype(np.uint32)


def launcher_payload(rng: np.random.Generator, n: int,
                     dtype: str) -> np.ndarray:
    """``n`` keys as the launcher's mixed stream draws them for ``dtype``."""
    if dtype == "uint32":
        return rng.integers(0, 1 << 32, size=n,
                            dtype=np.uint64).astype(np.uint32)
    if dtype == "int32":
        return rng.integers(-(1 << 31), 1 << 31, size=n,
                            dtype=np.int64).astype(np.int32)
    if dtype == "float32":
        return (rng.normal(size=n) * 1e3).astype(np.float32)
    raise ValueError(f"unknown payload dtype {dtype!r}")
