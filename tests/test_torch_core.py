"""Port core vs the JAX reference: packed substrate, sortable top-k engine,
and the copied numpy models.  Every output is an integer or a bit pattern,
so every comparison is exact equality."""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmatrix as ref_bm
from repro.core import baseline_sort, colskip_sort, costmodel as ref_cost
from repro.core import make_dataset
from repro_torch.core import bitmatrix as bm
from repro_torch.core import topk as tk
from repro_torch.core import baseline18 as port_b18
from repro_torch.core import colskip as port_colskip
from repro_torch.core import costmodel as port_cost
from repro_torch.core.datasets import DATASETS, make_dataset as port_dataset
from repro_torch.sortserve.request import decode_values, encode_payload

ref_tk = importlib.import_module("repro.core.topk")


# ----------------------------------------------------------- bit substrate
@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 64, 100])
def test_bitmatrix_matches_reference(n):
    """The cases of test_packed_machine's substrate test, through both
    packages: words, unpack, popcount, any_lane, ranks, tail mask."""
    rng = np.random.default_rng(n)
    bits = rng.random((3, n)) < 0.4
    want = ref_bm.pack_rows(bits)
    got = bm.pack_rows(torch.from_numpy(bits))
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert np.array_equal(bm.unpack_rows(got, n).numpy(), bits)
    assert np.array_equal(bm.popcount(got).numpy(), ref_bm.popcount(want))
    assert np.array_equal(bm.any_lane(got).numpy(), ref_bm.any_lane(want))
    assert np.array_equal(bm.cumsum_bits(got, n).numpy(),
                          ref_bm.cumsum_bits(want, n))
    assert np.array_equal(bm.tail_mask(n).numpy(),
                          ref_bm.tail_mask(n).astype(np.int64))
    assert bm.packed_words(n) == ref_bm.packed_words(n)
    # tail padding stays zero, so word ops are exact set operations
    assert not (got & (bm.tail_mask(n) ^ bm.WORD_MASK)).any()


@pytest.mark.parametrize("w", [8, 16, 32])
def test_pack_planes_and_word_carriers(w):
    rng = np.random.default_rng(w)
    u = rng.integers(0, 1 << w, size=(2, 70), dtype=np.uint64).astype(np.uint32)
    want = ref_bm.pack_planes(u, w).astype(np.int64)
    for x in (torch.from_numpy(u), torch.from_numpy(u.view(np.int32))):
        assert np.array_equal(bm.pack_planes(x, w).numpy(), want)
    c = bm.as_words(torch.from_numpy(u))
    assert c.dtype == torch.int64 and (c >= 0).all()
    assert np.array_equal(bm.to_uint32(c).numpy(), u)


# ---------------------------------------------------------- sortable top-k
def _inputs(dtype: str, case: str, rng, shape=(4, 50)):
    """The same values for both packages: (jax array, torch tensor)."""
    if dtype == "i32":
        x = rng.integers(-2 ** 31, 2 ** 31, shape).astype(np.int32)
    elif dtype == "u32":
        x = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    else:
        x = (rng.normal(size=shape) * 10).astype(np.float32)
    if case == "constant":
        x = np.repeat(x[:, :1], shape[1], axis=1)
    elif case == "ties":                  # four distinct values per row
        x = np.ascontiguousarray(x[:, rng.integers(0, 4, shape[1])])
    if dtype == "bf16":
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        return jx, torch.from_numpy(
            np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["f32", "i32", "u32", "bf16"])
@pytest.mark.parametrize("case", ["random", "constant", "ties"])
def test_topk_functions_match_reference(dtype, case):
    rng = np.random.default_rng(len(dtype) * 10 + len(case))
    jx, tx = _inputs(dtype, case, rng)
    ru = np.asarray(ref_tk.to_sortable_uint(jx))
    pu = tk.to_sortable_uint(tx)
    assert np.array_equal(pu.numpy(), ru.astype(np.int64))
    assert np.array_equal(tk.discriminating_planes(pu).numpy(),
                          np.asarray(ref_tk.discriminating_planes(ru)))
    for k in (1, 7, 50):
        rt = np.asarray(ref_tk.kth_largest_sortable(jnp.asarray(ru), k))
        pt = tk.kth_largest_sortable(pu, k)
        assert np.array_equal(pt.numpy(), rt.astype(np.int64))
        assert np.array_equal(
            tk.exact_k_mask(pu, pt[:, None], k).numpy(),
            np.asarray(ref_tk.exact_k_mask(jnp.asarray(ru), rt[:, None], k)))
        assert np.array_equal(tk.topk_mask(tx, k).numpy(),
                              np.asarray(ref_tk.topk_mask(jx, k)))
    back = tk.from_sortable_uint(pu, tx.dtype)
    assert torch.equal(back, tx)
    want = np.asarray(ref_tk.from_sortable_uint(jnp.asarray(ru), jx.dtype))
    assert np.array_equal(
        back.to(torch.float32).numpy() if dtype == "bf16" else back.numpy(),
        want.astype(np.float32) if dtype == "bf16" else want)


def test_kth_largest_rejects_bad_k():
    u = torch.zeros((2, 8), dtype=torch.int64)
    for k in (0, 9):
        with pytest.raises(ValueError):
            tk.kth_largest_sortable(u, k)


def test_encode_payload_is_to_sortable_uint():
    rng = np.random.default_rng(0)
    for x in ((rng.normal(size=256) * 1e4).astype(np.float32),
              rng.integers(-2 ** 31, 2 ** 31, 256).astype(np.int32),
              rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)):
        enc = encode_payload(x)
        assert np.array_equal(enc.astype(np.int64),
                              tk.to_sortable_uint(torch.from_numpy(x)).numpy())
        assert np.array_equal(decode_values(enc, x.dtype), x)


# --------------------------------------------------- copied numpy models
@pytest.mark.parametrize("name", sorted(DATASETS))
def test_numpy_models_match_reference(name):
    x = port_dataset(name, 96, 16, seed=3)
    assert np.array_equal(x, make_dataset(name, 96, 16, seed=3))
    for k in (0, 2):
        a = port_colskip.colskip_sort(x, 16, k, stop_after=40)
        b = colskip_sort(x, 16, k, stop_after=40)
        assert np.array_equal(a.values, b.values)
        assert np.array_equal(a.order, b.order)
        assert (a.column_reads, a.cycles) == (b.column_reads, b.cycles)
    a, b = port_b18.baseline_sort(x, 16), baseline_sort(x, 16)
    assert np.array_equal(a.values, b.values) and a.cycles == b.cycles


def test_costmodel_copy_matches_reference():
    for n in (64, 1024, 2048):
        assert port_cost.estimate_colskip_cycles(n) == \
            ref_cost.estimate_colskip_cycles(n)
        assert dataclasses.asdict(
            port_cost.colskip_cost(7.84, n=n, w=32, k=2, banks=4)) == \
            dataclasses.asdict(
                ref_cost.colskip_cost(7.84, n=n, w=32, k=2, banks=4))
