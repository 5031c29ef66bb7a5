"""The port's plain colskip machine vs the JAX reference, exactly.

Held against the Pallas kernel in interpret mode (the kernel's shapes of
test_kernels.py, plus k=0, stop_after and a B not a multiple of the tile)
and against the vmapped reference engine ``sort_ref`` over the paper's
datasets.  All four outputs — values, order, column reads, cycles — must
be equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.datasets import DATASETS, make_dataset
from repro.kernels.colskip import colskip_sort_batched as ref_sort_batched
from repro.kernels.colskip.ref import sort_ref
from repro_torch.core.colskip import colskip_sort as port_hw_model
from repro_torch.kernels.colskip import colskip_sort_batched

FIELDS = ("values", "order", "column_reads", "cycles")


def _assert_same(got, want):
    for field, g, w in zip(FIELDS, got, want):
        w = np.asarray(w)
        assert g.dtype == getattr(torch, str(w.dtype)), field
        assert np.array_equal(g.numpy(), w), field


@pytest.mark.parametrize("b,n,w,k,stop", [
    (3, 64, 16, 2, None), (2, 128, 32, 1, None), (4, 32, 8, 3, None),
    (3, 64, 16, 0, None),                      # k=0: no state table
    (3, 40, 16, 2, 7), (2, 33, 16, 4, 1),      # k-early-exit drain
    (5, 64, 16, 2, None),                      # B not a multiple of tb=4
])
def test_plain_machine_matches_pallas_interpret(b, n, w, k, stop):
    rng = np.random.default_rng(b + n + w + k)
    x = rng.integers(0, 1 << w, size=(b, n)).astype(np.uint32)
    if k == 0:
        x[0] %= 5                              # duplicate-heavy drain stalls
    want = ref_sort_batched(jnp.asarray(x), w, k, use_pallas=True,
                            interpret=True, stop_after=stop)
    got = colskip_sort_batched(x, w, k, stop_after=stop, device="cpu")
    _assert_same(got, want)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_machine_matches_sort_ref_over_datasets(k):
    names = sorted(DATASETS)
    x = np.stack([make_dataset(nm, 128, 32, seed=i)
                  for i, nm in enumerate(names)]).astype(np.uint32)
    want = sort_ref(jnp.asarray(x), 32, k)
    got = colskip_sort_batched(torch.from_numpy(x), 32, k, device="cpu")
    _assert_same(got, want)


def test_plain_machine_matches_copied_hardware_model():
    x = np.stack([make_dataset("kruskal", 96, 32, seed=s)
                  for s in range(2)]).astype(np.uint32)
    vals, order, crs, cyc = colskip_sort_batched(x, 32, 2, stop_after=50,
                                                 device="cpu")
    for r in range(2):
        hw = port_hw_model(x[r].astype(np.uint64), 32, 2, stop_after=50)
        assert np.array_equal(vals[r].numpy(), hw.values.astype(np.uint32))
        assert np.array_equal(order[r].numpy(), hw.order)
        assert (int(crs[r]), int(cyc[r])) == (hw.column_reads, hw.cycles)


def test_dense_machine_and_bad_arguments_raise():
    x = np.zeros((2, 8), np.uint32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        colskip_sort_batched(x, packed=False, device="cpu")
    with pytest.raises(ValueError):
        colskip_sort_batched(x, stop_after=0, device="cpu")
    with pytest.raises(ValueError):
        colskip_sort_batched(x, w=33, device="cpu")


def test_vote_chain_probe_has_no_cpu_version():
    from repro_torch.kernels.colskip.ops import vote_chain
    with pytest.raises(ValueError, match="measures the card"):
        vote_chain(8, device="cpu")
