"""The port's CUDA kernels, emulated on the CPU, against their plain versions.

The kernels run on the card only, so ``tests/test_torch_gpu.py`` (marked
``gpu``) holds them there.  Here each ``csrc/*.cu`` is compiled with g++
against the emulation in ``tests/cuda_emu/`` (``tests/_cuda_emu.py``) and
its C entry points are called on CPU tensors: the packed colskip kernel on
its register path (WPL 1, 2) and its shared path (WPL >= 4), also built
with another fusion depth (``-DCOLSKIP_FUSE=1`` and ``4``, as
``scripts/colskip_fuse.py`` builds it for the card), the dense carrier,
the chain probes, and the bitonic kernel in one block and in clusters of
2 and 4 blocks.  Every output must equal the plain version's exactly.
Shapes are small: an emulated warp round costs microseconds of barriers.
"""

import ctypes

import numpy as np
import pytest
import torch

from _cuda_emu import build, compiler
from repro_torch.kernels import _build
from repro_torch.kernels.colskip import ref as colskip_ref

VP, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if compiler() is None:
        pytest.skip("the CUDA emulation needs g++")
    out = tmp_path_factory.mktemp("cuda_emu")
    srcs = _build.sources()
    colskip = build(srcs["colskip"], out)
    colskip.colskip_chain_launch.argtypes = [VP, ctypes.c_uint, I, I, VP]
    bitonic = build(srcs["bitonic"], out)
    bitonic.bitonic_sort_launch.argtypes = [VP, VP, I, I, VP]
    fused = {colskip.colskip_fuse(): colskip}
    for f in (1, 4):
        fused[f] = build(srcs["colskip"], out, [f"COLSKIP_FUSE={f}"])
    for lib in fused.values():
        lib.colskip_sort_launch.argtypes = [VP] * 5 + [I] * 6 + [VP]
        lib.emu_rounds.argtypes = [I]
        lib.emu_rounds.restype = ctypes.c_long
    return {"colskip": colskip, "bitonic": bitonic, "fused": fused}


def _colskip(lib, x: np.ndarray, w: int, k: int, stop: int, packed=True):
    b, n = x.shape
    xt = torch.from_numpy(x.view(np.int32)).contiguous()
    vals = torch.zeros((b, stop), dtype=torch.int32)
    order = torch.zeros((b, stop), dtype=torch.int32)
    crs = torch.zeros((b,), dtype=torch.int32)
    cyc = torch.zeros((b,), dtype=torch.int32)
    args = [xt.data_ptr(), vals.data_ptr(), order.data_ptr(), crs.data_ptr(),
            cyc.data_ptr(), b, n, w, k, stop]
    assert lib.colskip_sort_launch(*args, int(packed), None) == 0
    return [vals.view(torch.uint32), order, crs, cyc]


def _rows(b, n, w, dupes, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << w, (b, n), dtype=np.uint64).astype(np.uint32)
    if dupes:
        x %= 9
    return x


def _same(got, want):
    for g, v in zip(got, want):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.uint32
                           else g,
                           v.view(torch.int32) if v.dtype == torch.uint32
                           else v)


@pytest.mark.parametrize("b,n,w,k,stop,dupes", [
    (3, 64, 16, 2, None, False), (2, 100, 32, 0, None, True),
    (2, 700, 32, 8, 16, False),                    # WPL 1
    (1, 1100, 32, 2, None, False),                 # WPL 2, full sort
    (2, 2048, 32, 1, 40, True),
    (2, 3000, 32, 2, 24, False),                   # WPL 4: shared path
    (1, 5000, 32, 8, None, True), (3, 17, 5, 8, None, False),
])
def test_emulated_packed_kernel_equals_plain(libs, b, n, w, k, stop, dupes):
    x = _rows(b, n, w, dupes, n + k)
    s = n if stop is None else stop
    got = _colskip(libs["colskip"], x, w, k, s)
    _same(got, colskip_ref.sort_ref(torch.from_numpy(x), w, k, s))


@pytest.mark.parametrize("fuse,b,n,k,stop", [
    (1, 2, 160, 2, None), (2, 2, 160, 2, None), (4, 2, 160, 2, None),
    (4, 1, 1100, 8, None),                         # WPL 2
    (1, 2, 3000, 1, 24), (4, 2, 3000, 0, 24),      # WPL 4: shared path
])
def test_emulated_fusion_variants_equal_plain(libs, fuse, b, n, k, stop):
    # the kernel built with COLSKIP_FUSE=fuse planes a round
    x = _rows(b, n, 32, False, 7)
    x[-1] %= 5
    s = n if stop is None else stop
    lib = libs["fused"][fuse]
    assert lib.colskip_fuse() == fuse
    got = _colskip(lib, x, 32, k, s)
    _same(got, colskip_ref.sort_ref(torch.from_numpy(x), 32, k, s))


def test_emulated_kernel_fuses_planes(libs):
    # the kernel resolves a block of planes per OR round: fewer rounds than
    # the kernel built one plane a round, for the same CRs (the emulation
    # counts the warp collectives issued)
    x = _rows(1, 256, 32, False, 5)
    assert libs["colskip"].colskip_fuse() == 2
    rounds, crs = [], []
    for lib in (libs["colskip"], libs["fused"][1]):
        lib.emu_rounds(1)
        out = _colskip(lib, x, 32, 2, 256)
        rounds.append(lib.emu_rounds(1))
        crs.append(int(out[2][0]))
    assert crs[0] == crs[1] and rounds[0] < 0.8 * rounds[1] < 0.8 * crs[0]


def test_emulated_dense_kernel_equals_plain(libs):
    x = _rows(3, 100, 16, True, 3)
    got = _colskip(libs["colskip"], x, 16, 2, 100, packed=False)
    _same(got, colskip_ref.sort_ref(torch.from_numpy(x), 16, 2, 100,
                                    packed=False))


def test_emulated_chain_probes_agree(libs):
    outs = []
    for redux in (0, 1):
        out = torch.zeros((1,), dtype=torch.int32)
        assert libs["colskip"].colskip_chain_launch(out.data_ptr(), 5, 200,
                                                    redux, None) == 0
        outs.append(int(out[0]))
    assert outs[0] == outs[1] and 5 * (200 // 32) <= outs[0] <= 200


@pytest.mark.parametrize("b,n", [
    (3, 1), (2, 8), (3, 64), (2, 1024),
    (2, 4096),                         # one block of 512 threads
    (1, 8192),                         # a cluster of 2 blocks
    (1, 16384),                        # a cluster of 4
    (2, 8192), (13, 32),
])
def test_emulated_bitonic_equals_np_sort(libs, b, n):
    rng = np.random.default_rng(b * n)
    x = rng.integers(0, 1 << 32, (b, n), dtype=np.uint64).astype(np.uint32)
    out = np.zeros_like(x)
    assert libs["bitonic"].bitonic_sort_launch(
        x.ctypes.data, out.ctypes.data, b, n, None) == 0
    assert np.array_equal(out, np.sort(x, -1))
