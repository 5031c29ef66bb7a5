"""The port's CUDA kernels, emulated on the CPU, against their plain versions.

The kernels run on the card only, so ``tests/test_torch_gpu.py`` (marked
``gpu``) holds them there.  Here each ``csrc/*.cu`` is compiled with g++
against the emulation in ``tests/cuda_emu/`` (``tests/_cuda_emu.py``) and
its C entry points are called on CPU tensors: the packed colskip kernel on
its register path (WPL 1, 2) and its shared path (WPL >= 4), also built
with another fusion depth (``-DCOLSKIP_FUSE=1`` and ``4``, as
``scripts/colskip_fuse.py`` builds it for the card); the dense carrier on
every instance (registers at C = 4, 8, 16 elements a thread, the table
in registers or shared memory, and the rolled one-warp shared-memory
instance), also built at those fusion depths; the chain probes; the radix
threshold kernel (a cluster of 8 blocks a tile, both entries, the
streamed instance); and the bitonic kernel in one block and in clusters of 2 and 4 blocks.  Every
output must equal the plain version's exactly.  Shapes are small: an
emulated warp round costs microseconds of barriers.
"""

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _cuda_emu import build, compiler
from repro_torch.core.topk import to_sortable_uint
from repro_torch.kernels import _build
from repro_torch.kernels.colskip import ref as colskip_ref
from repro_torch.kernels.radix_topk import ref as radix_ref

VP, I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if compiler() is None:
        pytest.skip("the CUDA emulation needs g++")
    out = tmp_path_factory.mktemp("cuda_emu")
    srcs = _build.sources()
    jobs = {"colskip": ("colskip", []), "bitonic": ("bitonic", []),
            "fuse1": ("colskip", ["COLSKIP_FUSE=1"]),
            "fuse4": ("colskip", ["COLSKIP_FUSE=4"]),
            "radix": ("radix_threshold", [])}
    with ThreadPoolExecutor(3) as pool:        # g++ runs outside the GIL
        built = dict(zip(jobs, pool.map(
            lambda job: build(srcs[job[0]], out, job[1]), jobs.values())))
    colskip, bitonic = built["colskip"], built["bitonic"]
    colskip.colskip_chain_launch.argtypes = [VP, ctypes.c_uint, I, I, VP]
    bitonic.bitonic_sort_launch.argtypes = [VP, VP, I, I, VP]
    fused = {colskip.colskip_fuse(): colskip, 1: built["fuse1"],
             4: built["fuse4"]}
    for lib in fused.values():
        lib.colskip_sort_launch.argtypes = [VP] * 5 + [I] * 6 + [VP]
        lib.emu_rounds.argtypes = [I]
        lib.emu_rounds.restype = ctypes.c_long
    dense = {"": colskip, "fuse1": fused[1], "fuse4": fused[4]}
    radix = built["radix"]
    radix.radix_threshold_launch.argtypes = [VP, VP, VP, I, I, I, I, VP]
    radix.emu_rounds.argtypes = [I]
    radix.emu_rounds.restype = ctypes.c_long
    assert radix.radix_digit_bits() == 8
    return {"colskip": colskip, "bitonic": bitonic, "fused": fused,
            "dense": dense, "radix": radix}


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


# the dense carrier's instances: registers (C = 4, 8, 16 elements a
# thread at four warps a row; the table in registers at k <= 2, in shared
# memory above) up to N = 2048, the rolled one-warp shared-memory instance
# past it; every k, stop_after in {1, 16, N}, ragged B, other fusion depths
@pytest.mark.parametrize("build,b,n,w,k,stop,dupes", [
    ("", 3, 100, 16, 2, None, True),               # C = 4
    ("", 2, 128, 32, 8, None, False),
    ("", 5, 200, 32, 1, 16, False),
    ("", 2, 256, 32, 8, 1, True),
    ("", 2, 500, 32, 0, None, True),
    ("", 1, 1000, 32, 8, 16, False),               # C = 8
    ("", 2, 1024, 32, 2, 16, False),
    ("", 1, 900, 32, 8, None, True),
    ("", 3, 2048, 32, 1, 16, False),               # C = 16
    ("", 1, 2000, 32, 8, 1, False),
    ("", 1, 1500, 32, 2, None, True),
    ("", 2, 2100, 32, 2, 16, False),               # rolled
    ("", 1, 3000, 32, 8, None, True),
    ("", 3, 2500, 24, 0, 1, False),
    ("fuse1", 2, 160, 32, 2, None, False),
    ("fuse1", 1, 2200, 32, 8, 16, True),
    ("fuse4", 2, 700, 32, 8, None, True),
    ("fuse4", 3, 1100, 32, 1, 16, False),
    ("", 3, 2048, 32, 2, None, True),              # C = 16, full sort
    ("", 2, 1900, 32, 0, 1, False),
    ("", 3, 300, 32, 2, None, True),
    ("", 2, 2200, 32, 1, None, False),             # rolled, full sort
    ("fuse4", 2, 2048, 32, 8, 16, False),
])
def test_emulated_dense_kernel_equals_plain(libs, build, b, n, w, k, stop,
                                            dupes):
    x = _rows(b, n, w, dupes, n + k + 3)
    s = n if stop is None else stop
    got = _colskip(libs["dense"][build], x, w, k, s, packed=False)
    _same(got, colskip_ref.sort_ref(torch.from_numpy(x), w, k, s,
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


def _radix(lib, x: np.ndarray, k: int, float_in: bool):
    b, n = x.shape
    x = np.ascontiguousarray(x)
    thresh = np.zeros(b, np.uint32)
    visited = np.zeros(b, np.int32)
    assert lib.radix_threshold_launch(x.ctypes.data, thresh.ctypes.data,
                                      visited.ctypes.data, b, n, k,
                                      int(float_in), None) == 0
    return thresh, visited


# the radix kernel: a block a row, a cluster of 8 blocks a tile.  B not a
# multiple of the tile, a constant row and a constant ragged tile (its
# visited is 0), k = 1 and k = N, N not a multiple of the 512-thread
# block, positive data (the leading planes skipped: visited < 32), the
# streamed instance (N past the shared-memory row)
@pytest.mark.parametrize("b,n,k,data", [
    (3, 1000, 5, "normal"), (8, 128, 1, "normal"),
    (13, 700, 700, "normal"), (8, 4096, 32, "normal"),
    (13, 300, 3, "positive"), (3, 64, 64, "positive"),
    (2, 16500, 100, "normal"),
    (13, 1000, 7, "normal"), (8, 513, 513, "positive"),
    (1, 16400, 1, "positive"),
])
def test_emulated_radix_kernel_equals_plain(libs, b, n, k, data):
    rng = np.random.default_rng(b * n + k)
    x = rng.normal(size=(b, n)).astype(np.float32) * 100
    if data == "positive":                     # sign and exponent uniform
        x = np.abs(x) * 1e-5
    x[min(1, b - 1)] = np.float32(-2.5)        # a constant row
    if b > 8:
        x[8:] = np.float32(3.0)                # a constant ragged tile
    u = to_sortable_uint(torch.from_numpy(x))
    want_t, want_v = radix_ref.threshold_ref(u, k)
    want_t = want_t.view(torch.int32).numpy()
    lib = libs["radix"]
    entries = [(u.numpy().astype(np.uint32), False)]
    if n <= lib.radix_smem_n():                # float32 rows stay in smem
        entries.append((x, True))
    for arr, float_in in entries:
        thresh, visited = _radix(lib, arr, k, float_in)
        assert np.array_equal(thresh.view(np.int32), want_t)
        assert np.array_equal(visited, want_v.numpy())
    if b > 8:
        assert not visited[8:].any() and visited[:8].all()
    if data == "positive":
        assert visited.max() < 32


def test_emulated_radix_kernel_descends_by_digits(libs):
    # one barrier-separated pass a digit of 8 planes: tiles whose mixed
    # planes span 8, 16 and 32 planes take 1, 2 and 4 digit passes, each
    # as many warp rounds as the next (the emulation counts the
    # collectives issued), with the plain version's thresholds
    lib, rng, rounds = libs["radix"], np.random.default_rng(2), {}
    for planes in (8, 16, 32):
        u = rng.integers(0, 1 << planes, (8, 600),
                         dtype=np.uint64).astype(np.uint32)
        for kind in range(4):
            lib.emu_rounds(kind)
        thresh, visited = _radix(lib, u, 9, False)
        rounds[planes] = sum(lib.emu_rounds(kind) for kind in range(4))
        want_t, want_v = radix_ref.threshold_ref(torch.from_numpy(u), 9)
        assert np.array_equal(thresh.view(np.int32),
                              want_t.view(torch.int32).numpy())
        assert np.array_equal(visited, want_v.numpy())
        assert visited.max() == planes
    one = rounds[16] - rounds[8]
    assert one > 0 and rounds[32] - rounds[8] == 3 * one
