"""The plain reference: orders against numpy's stable sorts, the fast
column-read count against the column-by-column machine."""

import numpy as np
import pytest
import torch

import _small  # noqa: F401  (puts the repository on sys.path)
from perfbench.reference import sortref, verify


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
def test_encode_preserves_order(dtype):
    rng = np.random.default_rng(0)
    if dtype == "float32":
        x = (rng.normal(size=500) * 1e3).astype(np.float32)
        x[:3] = [0.0, -0.0, -1e-30]
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, size=500, dtype=np.int64)
        x = x.astype(dtype)
    u = sortref.encode(x)
    assert u.dtype == np.uint32
    order = np.argsort(u, kind="stable")
    assert np.all(np.diff(x[order].astype(np.float64)) >= 0)


@pytest.mark.parametrize("op", ["sort", "argsort", "kmin", "topk"])
@pytest.mark.parametrize("n", [1, 7, 64, 300])
def test_answer_matches_numpy(op, n):
    rng = np.random.default_rng(n)
    u = rng.integers(0, 16, size=n, dtype=np.uint64).astype(np.uint32)
    k = max(1, n // 3)
    got = sortref.answer(op, u, k)
    if op in ("sort", "argsort"):
        np.testing.assert_array_equal(got, np.argsort(u, kind="stable"))
        np.testing.assert_array_equal(u[got], np.sort(u))
    elif op == "kmin":
        np.testing.assert_array_equal(got, np.argsort(u, kind="stable")[:k])
    else:
        want = sorted(range(n), key=lambda j: (-int(u[j]), j))[:k]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("descending", [False, True])
def test_torch_orders_match_numpy(descending):
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 50, size=(9, 40), dtype=np.uint64).astype(np.uint32)
    got = verify._orders(rows, descending, torch.device("cpu"))
    for r in range(rows.shape[0]):
        op = "topk" if descending else "sort"
        np.testing.assert_array_equal(got[r], sortref.answer(op, rows[r], 40))


@pytest.mark.parametrize("case", range(40))
def test_fast_reads_equal_the_plain_machine(case):
    rng = np.random.default_rng(100 + case)
    w = int(rng.choice([4, 8, 32]))
    n = int(rng.integers(1, 90))
    k = int(rng.integers(0, 4))
    hi = 4 if case % 3 == 0 else 1 << w
    row = rng.integers(0, hi, size=n, dtype=np.uint64)
    stop = None if case % 2 else int(rng.integers(1, n + 1))
    assert sortref.colskip_reads(row, w, k, stop) == \
        sortref.colskip_reads_plain(row, w, k, stop)


def test_reads_depend_on_the_multiset_only():
    rng = np.random.default_rng(3)
    row = rng.integers(0, 1 << 32, size=256, dtype=np.uint64)
    base = sortref.colskip_reads(row)
    for off in (1, 100, 255):
        assert sortref.colskip_reads(np.roll(row, off)) == base
        assert sortref.colskip_reads_plain(np.roll(row, off)) == base


def test_reads_of_sorted_and_constant_rows():
    # all keys equal: one search of w reads, the rest drain one a cycle
    assert sortref.colskip_reads(np.full(10, 7), w=8) == (8, 8 + 9)
    # the baseline without skipping reads every column for every key
    row = np.arange(16)
    reads, cycles = sortref.colskip_reads(row, w=4, k=0)
    assert reads == cycles <= 16 * 4


def test_plane_reads_and_padding():
    row = np.array([0b1010, 0b1000, 0b1110], np.uint32)
    assert sortref.plane_reads(row) == 2
    padded = sortref.padded_row(row, "kmin", 8)
    assert list(padded[3:]) == [0xFFFFFFFF] * 5
    assert sortref.plane_reads(padded) == 32 - 1
    assert list(sortref.padded_row(row, "topk", 4)[3:]) == [0]
    assert sortref.pow2_width(5, 8) == 8
    assert sortref.pow2_width(1025, 8) == 2048
