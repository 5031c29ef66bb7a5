"""The port's bitonic network vs the JAX reference, exactly.

The plain torch network (``repro_torch.kernels.bitonic.ref``) is held
against the Pallas kernel in interpret mode at the shapes of
test_kernels.py and over its property sweep of widths, plus N=1; the
wrapper refuses a width that is not a power of two and, by default, asks
for the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitonic import bitonic_sort as ref_bitonic_sort
from repro.kernels.bitonic import n_passes as ref_n_passes
from repro_torch.kernels.bitonic import bitonic_sort, n_passes


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.uint32
    return t.view(torch.int32).numpy().view(np.uint32)


def _jax(x: np.ndarray) -> np.ndarray:
    return np.asarray(ref_bitonic_sort(jnp.asarray(x), use_pallas=True,
                                       interpret=True))


@pytest.mark.parametrize("b,n", [(3, 64), (5, 256), (2, 1024), (7, 128)])
def test_plain_network_matches_pallas_interpret(b, n):
    rng = np.random.default_rng(b * n)
    x = rng.integers(0, 2**32, (b, n), dtype=np.uint64).astype(np.uint32)
    got = _u32(bitonic_sort(x, device="cpu"))
    assert np.array_equal(got, _jax(x))
    assert np.array_equal(got, np.sort(x, axis=-1))


@pytest.mark.parametrize("logn", range(3, 9))
def test_plain_network_matches_pallas_over_widths(logn):
    n = 1 << logn
    rng = np.random.default_rng(logn)
    x = rng.integers(0, 2**16, (2, n), dtype=np.uint64).astype(np.uint32)
    got = _u32(bitonic_sort(torch.from_numpy(x), device="cpu"))
    assert np.array_equal(got, _jax(x))


def test_width_one_makes_no_pass():
    x = np.array([[7], [0xFFFFFFFF], [0]], np.uint32)
    assert n_passes(1) == ref_n_passes(1) == 0
    assert np.array_equal(_u32(bitonic_sort(x, device="cpu")), x)
    assert np.array_equal(_jax(x), x)


def test_pass_count_and_input_words_match_reference():
    for n in (1, 2, 8, 1024, 1 << 20):
        assert n_passes(n) == ref_n_passes(n)
    # int32 bit patterns sort as the unsigned words they are
    x = np.array([[-1, 0, 5, -7]], np.int32)
    got = _u32(bitonic_sort(torch.from_numpy(x), device="cpu"))
    assert np.array_equal(got, np.sort(x.view(np.uint32), axis=-1))


@pytest.mark.parametrize("n", [3, 96, 1000])
def test_width_not_a_power_of_two_raises(n):
    with pytest.raises(ValueError, match="power-of-two"):
        bitonic_sort(np.zeros((2, n), np.uint32), device="cpu")


def test_wrapper_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bitonic_sort(np.zeros((2, 8), np.uint32))
