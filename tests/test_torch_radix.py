"""The port's radix top-k vs the JAX reference, exactly.

Per-row thresholds **and** the tile-level ``visited`` telemetry against
``threshold_pallas`` in interpret mode (B not a multiple of the 8-row tile,
constant rows, both of the port's kernel entries), and ``radix_topk``
values and indices against the reference's, the two-level bank path
included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.radix_topk import radix_topk as ref_radix_topk
from repro.kernels.radix_topk.kernel import threshold_pallas
from repro_torch.core.bitmatrix import to_uint32
from repro_torch.core.topk import to_sortable_uint
from repro_torch.kernels.radix_topk import (
    radix_topk,
    radix_topk_threshold,
    threshold_sortable,
)
from repro_torch.kernels.radix_topk.ops import threshold_f32


@pytest.mark.parametrize("b,n,k,const", [
    (4, 128, 8, ()), (11, 256, 1, ()), (3, 640, 5, (1,)), (1, 128, 128, ()),
    (9, 64, 3, (0, 8)), (8, 32, 4, tuple(range(8))), (16, 1024, 32, (5,)),
])
def test_threshold_and_visited_match_pallas(b, n, k, const):
    rng = np.random.default_rng(b * 1000 + n + k)
    x = (rng.normal(size=(b, n)) * 10).astype(np.float32)
    for r in const:                              # constant rows
        x[r] = np.float32(r - 2.5)
    want_t, want_v = threshold_pallas(jnp.asarray(x), k, interpret=True)
    want_t = np.asarray(want_t)
    xt = torch.from_numpy(x)
    for got_t, got_v in (threshold_f32(xt, k),
                         threshold_sortable(to_uint32(to_sortable_uint(xt)),
                                            k, device="cpu")):
        assert got_t.dtype == torch.uint32 and got_v.dtype == torch.int32
        assert np.array_equal(got_t.numpy(), want_t)
        assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    assert np.array_equal(radix_topk_threshold(x, k, device="cpu").numpy(),
                          want_t)


def test_threshold_rejects_rows_past_max_n():
    with pytest.raises(ValueError, match="MAX_N"):
        threshold_f32(torch.zeros((1, 16385)), 1)


@pytest.mark.parametrize("shape,k,bank_width,dtype", [
    ((4, 128), 8, 16384, "float32"),
    ((2, 512), 16, 16384, "bfloat16"),
    ((3, 256), 4, 16384, "constant"),
    ((2, 3, 200), 5, 16384, "float32"),
    ((2, 50000), 17, 8192, "float32"),           # two-level bank path
    # the last bank mostly fill: 16 real columns, k = 40 takes its fill
    ((3, 16400), 40, 8192, "float32"),
    ((64, 40), 8, 16384, "ties"),                # the MoE router's rows
    ((4, 64), 16, 16384, "float32"),             # the manager pass's rows
])
def test_radix_topk_matches_reference(shape, k, bank_width, dtype):
    rng = np.random.default_rng(k)
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == "constant":
        x[:] = np.float32(-2.5)
    if dtype == "ties":                          # ties at the k-th value
        x = np.round(x * 2).astype(np.float32) / np.float32(2)
    jx = jnp.asarray(x)
    if dtype == "bfloat16":
        jx = jx.astype(jnp.bfloat16)
        tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
            torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    # the reference's jnp path where it banks (as its own test does), its
    # Pallas kernel in interpret mode elsewhere
    use_pallas = bank_width >= shape[-1]
    want_v, want_i = ref_radix_topk(jx, k, use_pallas=use_pallas,
                                    interpret=use_pallas or None,
                                    bank_width=bank_width)
    got_v, got_i = radix_topk(tx, k, bank_width=bank_width, device="cpu")
    assert got_v.dtype == tx.dtype and got_i.dtype == torch.int32
    assert np.array_equal(got_v.to(torch.float32).numpy(),
                          np.asarray(want_v.astype(jnp.float32)))
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    if dtype in ("float32", "ties"):
        lv, li = jax.lax.top_k(jnp.asarray(x), k)
        assert np.array_equal(got_i.numpy(), np.asarray(li))
