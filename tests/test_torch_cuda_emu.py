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
streamed instance; and rows of at most 1,024 words, a warp a row, its
threshold and fused top-k entries; the block instance's top-k entry with
its options: the complement, plane reads, banked rows and a payload);
the bitonic kernel in one block and in clusters of 2 and 4 blocks; and the
mesh kernel (a cluster of 2, 3, 4 or 8 CTAs a row, each a bank, the gates
an exchange through the cluster's shared memory, fuse 1 to 8) against the
plain mesh
and its chain probe.  Every output must equal the plain version's
exactly.  Shapes are small: an
emulated warp round costs microseconds of barriers.
"""

import ctypes
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _cuda_emu import build, compiler
from repro_torch.core.datasets import make_dataset
from repro_torch.core.topk import to_sortable_uint
from repro_torch.dist.bankmesh import collective_rounds
from repro_torch.kernels import _build
from repro_torch.kernels.colskip import ref as colskip_ref
from repro_torch.kernels.radix_topk import ops as radix_ops
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
            "radix": ("radix_threshold", []),
            "mesh": ("colskip_mesh", [])}
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
    radix.radix_select_launch.argtypes = [VP] * 5 + [I] * 6 + [VP]
    radix.emu_rounds.argtypes = [I]
    radix.emu_rounds.restype = ctypes.c_long
    assert radix.radix_digit_bits() == 8
    assert radix.radix_narrow_n() == radix_ops.NARROW_N
    mesh = built["mesh"]
    mesh.colskip_mesh_launch.argtypes = [VP] * 6 + [I] * 8 + [VP]
    mesh.colskip_mesh_chain_launch.argtypes = [VP, ctypes.c_uint, I, I, I,
                                               VP]
    mesh.emu_gate_rounds.argtypes = [I]
    mesh.emu_gate_rounds.restype = ctypes.c_long
    return {"colskip": colskip, "bitonic": bitonic, "fused": fused,
            "dense": dense, "radix": radix, "mesh": mesh}


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


# the radix kernel: a block a row, a cluster of 8 blocks a tile, for rows
# past 1,024 words (the narrow instance, a warp a row, below).  B not a
# multiple of the tile, a constant row and a constant ragged tile (its
# visited is 0), k = 1 and k = N, N not a multiple of the 512-thread
# block, positive data (the leading planes skipped: visited < 32), the
# streamed instance (N past the shared-memory row); the cases of 1,024
# words or fewer take the narrow instance
@pytest.mark.parametrize("b,n,k,data", [
    (3, 1000, 5, "normal"), (8, 128, 1, "normal"),
    (13, 700, 700, "normal"), (8, 4096, 32, "normal"),
    (13, 300, 3, "positive"), (3, 64, 64, "positive"),
    (2, 16500, 100, "normal"),
    (13, 1000, 7, "normal"), (8, 513, 513, "positive"),
    (1, 16400, 1, "positive"),
    (13, 1500, 7, "normal"), (9, 1025, 1025, "positive"),
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
    # collectives issued), with the plain version's thresholds; rows past
    # 1,024 words, so the block instance
    lib, rng, rounds = libs["radix"], np.random.default_rng(2), {}
    for planes in (8, 16, 32):
        u = rng.integers(0, 1 << planes, (8, 1100),
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


def _radix_topk(lib, x: np.ndarray, k: int):
    """The top-k entry with no options: (values, indices)."""
    return _select(lib, x, k)[:2]


# the narrow instance (rows of at most 1,024 words, a warp a row, 8 rows a
# block), both entries: the threshold entry against the plain threshold,
# the top-k entry against the plain radix_topk (values bit for bit,
# indices), each on float32 values and on sortable words.  B not a
# multiple of 8, a constant row, a constant ragged tile (B > 8), ties at
# the threshold ("dupes": values from a small set), +0.0, -0.0 and -inf
# ("signed"), k = 1, 8 and N
@pytest.mark.parametrize("b,n,k,data", [
    (13, 1, 1, "normal"), (3, 7, 1, "dupes"), (13, 7, 7, "signed"),
    (13, 32, 8, "dupes"), (3, 32, 32, "normal"), (13, 40, 8, "dupes"),
    (9, 40, 1, "signed"), (13, 40, 40, "normal"), (3, 64, 8, "signed"),
    (13, 64, 64, "dupes"), (13, 64, 1, "normal"), (3, 640, 8, "dupes"),
    (13, 640, 640, "signed"), (9, 640, 1, "normal"), (3, 1024, 1, "signed"),
    (13, 1024, 8, "normal"), (9, 1024, 1024, "dupes"),
])
def test_emulated_narrow_radix_equals_plain(libs, b, n, k, data):
    rng = np.random.default_rng(b * n + k)
    x = (rng.normal(size=(b, n)) * 100).astype(np.float32)
    if data == "dupes":                        # many ties at the threshold
        x = np.round(x / 60).astype(np.float32) * np.float32(60)
    if data == "signed":
        pick = rng.integers(0, 3, (b, n))
        x = np.where(pick == 0, np.float32(0.0),
                     np.where(pick == 1, np.float32(-0.0), x))
        x[:, ::5] = -np.inf
    x[min(1, b - 1)] = np.float32(-2.5)        # a constant row
    if b > 8:
        x[8:] = np.float32(3.0)                # a constant ragged tile
    xt = torch.from_numpy(x)
    u = to_sortable_uint(xt)
    want_t, want_v = radix_ref.threshold_ref(u, k)
    want_vals, want_idx = radix_ops.radix_topk(xt, k, device="cpu")
    want_u = to_sortable_uint(want_vals).numpy().astype(np.uint32)
    lib = libs["radix"]
    words = u.numpy().astype(np.uint32)
    for arr, float_in in ((x, True), (words, False)):
        thresh, visited = _radix(lib, arr, k, float_in)
        assert np.array_equal(thresh.view(np.int32),
                              want_t.view(torch.int32).numpy())
        assert np.array_equal(visited, want_v.numpy())
        vals, idxs = _radix_topk(lib, arr, k)
        assert np.array_equal(idxs, want_idx.numpy())
        got_u = (to_sortable_uint(torch.from_numpy(vals)).numpy()
                 .astype(np.uint32) if float_in else vals)
        assert np.array_equal(got_u, want_u)
    if b > 8:
        assert not visited[8:].any()


def test_emulated_narrow_radix_descends_a_plane_a_reduction(libs):
    # the narrow instance counts each plane from s_top down with one add
    # reduction a warp, and needs no shuffle: a tile of 8 rows whose mixed
    # planes span 8, 16 and 32 planes issues 8 x 8, 8 x 16 and 8 x 32 of
    # them, with the plain version's thresholds and the fused entry's
    # top-k equal to the plain radix_topk's
    lib, rng = libs["radix"], np.random.default_rng(3)
    for planes in (8, 16, 32):
        u = rng.integers(0, 1 << planes, (8, 40),
                         dtype=np.uint64).astype(np.uint32)
        for kind in range(4):
            lib.emu_rounds(kind)
        thresh, visited = _radix(lib, u, 8, False)
        adds, shuffles = lib.emu_rounds(2), lib.emu_rounds(3)
        want_t, want_v = radix_ref.threshold_ref(torch.from_numpy(u), 8)
        assert np.array_equal(thresh.view(np.int32),
                              want_t.view(torch.int32).numpy())
        assert np.array_equal(visited, want_v.numpy())
        assert visited.max() == planes
        assert adds == 8 * planes and shuffles == 0
        vals, idxs = _radix_topk(lib, u, 8)
        want_vals, want_idx = radix_ops.fused_topk(torch.from_numpy(u), 8)
        assert np.array_equal(vals, want_vals.numpy())
        assert np.array_equal(idxs, want_idx.numpy())


def _select(lib, x: np.ndarray, k: int, *, complement=False, bank=0,
            payload=None, packed=False):
    """The top-k entry with plane reads: (values, indices, reads), or with
    ``packed`` the one int32 (rows, 2k + 1) buffer that holds all three
    (ld_out = 2k + 1)."""
    b, n = x.shape
    x = np.ascontiguousarray(x)
    rows = b * (-(-n // bank) if bank else 1)
    if packed:
        buf = np.zeros((rows, 2 * k + 1), np.int32)
        ptrs = [buf.ctypes.data + 4 * j for j in (0, k, 2 * k)]
    else:
        vals = np.zeros((rows, k), x.dtype)
        idxs = np.zeros((rows, k), np.int32)
        reads = np.zeros(rows, np.int32)
        ptrs = [a.ctypes.data for a in (vals, idxs, reads)]
    flags = int(x.dtype == np.float32) | (2 if complement else 0)
    assert lib.radix_select_launch(
        x.ctypes.data, *ptrs,
        None if payload is None else payload.ctypes.data, b, n, k, bank,
        2 * k + 1 if packed else 0, flags, None) == 0
    return buf if packed else (vals, idxs, reads)


def _select_rows(b: int, n: int, k: int, data: str) -> np.ndarray:
    """(B, N) float32 rows seeded by the case: ties at the threshold
    ("dupes": values from a small set), +0.0, -0.0 and -inf ("signed"), a
    constant row, and a constant ragged tile when B > 8."""
    rng = np.random.default_rng(b * n + k)
    x = (rng.normal(size=(b, n)) * 100).astype(np.float32)
    if data == "dupes":                        # many ties at the threshold
        x = np.round(x / 60).astype(np.float32) * np.float32(60)
    if data == "signed":
        pick = rng.integers(0, 3, (b, n))
        x = np.where(pick == 0, np.float32(0.0),
                     np.where(pick == 1, np.float32(-0.0), x))
        x[:, ::5] = -np.inf
    x[min(1, b - 1)] = np.float32(-2.5)        # a constant row
    if b > 8:
        x[8:] = np.float32(3.0)                # a constant ragged tile
    return x


def _same_select(got, want) -> None:
    for g, w in zip(got, want):
        w = w.numpy()
        assert g.dtype == w.dtype and np.array_equal(g.view(np.int32),
                                                     w.view(np.int32))


# the block instance's top-k entry (rows past 1,024 words, a block a row):
# the threshold descent, then the selection (each warp a segment, its
# first slot and tie rank from the warps before it), the slots ordered by
# counting (k <= 64) or by a bitonic network (larger k), against the plain
# version: values bit for bit, indices and plane reads exact.  Float32
# values and sortable words, the complement (kmin) on the words; B not a
# multiple of 8, a constant row, a constant ragged tile (B > 8), ties at
# the threshold, +0.0, -0.0 and -inf; the streamed instance past
# radix_smem_n() words, its slots in shared memory and (k = 29,000, past
# what shared memory holds) in the output row
@pytest.mark.parametrize("b,n,k,data", [
    (9, 1025, 1, "signed"), (3, 1025, 1025, "dupes"), (9, 1500, 8, "dupes"),
    (3, 1500, 64, "signed"), (9, 2048, 64, "normal"),
    (3, 2048, 2048, "signed"), (2, 16500, 64, "dupes"),
    (1, 29000, 29000, "dupes"),
])
def test_emulated_block_topk_entry_equals_plain(libs, b, n, k, data):
    x = _select_rows(b, n, k, data)
    lib = libs["radix"]
    words = to_sortable_uint(torch.from_numpy(x)).numpy().astype(np.uint32)
    cases = [(words, False), (words, True)]
    if n <= lib.radix_smem_n():                # float32 rows stay in smem
        cases.append((x, False))
    for arr, complement in cases:
        got = _select(lib, arr, k, complement=complement)
        want = radix_ops._plain_topk(torch.from_numpy(arr), k,
                                     complement=complement, reads=True)
        _same_select(got, want)
    if b > 8:
        assert not got[2][8:].any()            # constant rows: no reads


# a sort-serving tile's launch on either instance: sortable words, topk
# and kmin (the complement), each row's plane reads, the one packed int32
# (B, 2k + 1) buffer (ld_out), against the plain version's packed buffer;
# the narrow instance at the smoke's tile widths and the block instance
@pytest.mark.parametrize("b,n,k,data", [
    (13, 64, 64, "dupes"), (8, 300, 17, "dupes"), (8, 1024, 32, "normal"),
    (9, 640, 1, "signed"), (9, 1500, 37, "dupes"),
])
def test_emulated_packed_tile_launch_equals_plain(libs, b, n, k, data):
    words = to_sortable_uint(torch.from_numpy(
        _select_rows(b, n, k, data))).numpy().astype(np.uint32)
    for complement in (False, True):
        got = _select(libs["radix"], words, k, complement=complement,
                      packed=True)
        want = radix_ops._plain_topk(torch.from_numpy(words), k,
                                     complement=complement, reads=True,
                                     packed=True)
        assert np.array_equal(got, want.numpy())
    if b > 8:
        assert not got[8:, 2 * k].any()        # constant rows: no reads


# banked rows read in place: V = 2 banks and a ragged tail of 37 words at a
# bank width of 1,100 (k = 64 takes fill from the tail, whose -inf words
# carry the indices the reference's padding gives them), a block each;
# then the manager pass over the banks' candidates with their global
# indices as its payload (on the narrow instance at 3 x 64 words, on the
# block instance at 3 x 400), equal to the plain radix_topk at that bank
# width
@pytest.mark.parametrize("b,k", [(3, 64), (2, 400)])
def test_emulated_banked_topk_and_payload_manager_pass(libs, b, k):
    lib, width = libs["radix"], 1100
    rng = np.random.default_rng(k)
    x = rng.normal(size=(b, 2 * width + 37)).astype(np.float32)
    x[0, :20] = x[0, 1200:1220]                # ties across banks
    vb, ib, _ = _select(lib, x, k, bank=width)
    want_vb, want_ib = radix_ops._plain_topk(torch.from_numpy(x), k,
                                             bank=width)
    _same_select((vb, ib), (want_vb, want_ib))
    assert (ib[2::3] >= x.shape[1]).any()      # the tail's fill was taken
    cand_v, cand_i = vb.reshape(b, -1), ib.reshape(b, -1)
    vals, idxs, _ = _select(lib, cand_v, k, payload=cand_i)
    want = radix_ops.radix_topk(torch.from_numpy(x), k, bank_width=width,
                                device="cpu")
    _same_select((vals, idxs), want)


def _mesh(lib, x: np.ndarray, banks: int, w: int, k: int, stop: int,
          fuse: int, packed: bool = True):
    b, n = x.shape
    xt = torch.from_numpy(x.view(np.int32)).contiguous()
    vals = torch.zeros((b, stop), dtype=torch.int32)
    order = torch.zeros((b, stop), dtype=torch.int32)
    crs, cyc, rounds = (torch.zeros((b,), dtype=torch.int32)
                        for _ in range(3))
    assert lib.colskip_mesh_launch(
        xt.data_ptr(), vals.data_ptr(), order.data_ptr(), crs.data_ptr(),
        cyc.data_ptr(), rounds.data_ptr(), b, n, banks, w, k, stop, fuse,
        int(packed), None) == 0
    return [vals.view(torch.uint32), order, crs, cyc], rounds


def _mesh_gates(lib):
    """Clear the emulation's tally of mesh rounds by gate; returns a call
    that reads (and clears) the (block, drain) rounds made since."""
    def read():
        return [lib.emu_gate_rounds(g) for g in range(2)]
    read()
    return read


def _mesh_case(packed, banks, fuse, k, stop, b, n, dupes, w=32):
    """A mesh case; rows of ``w`` < 32 bits add ``-w<w>`` to its id."""
    vals = (packed, banks, fuse, k, stop, b, n, dupes)
    return pytest.param(*vals, w, id="-".join(map(str, vals))
                        + ("" if w == 32 else f"-w{w}"))


# the mesh kernels: clusters of 2, 4 and 8 CTAs (and 3, a cluster size
# that is not a power of two), fuse 1 to 8 (3, 5, 6, 7: a ragged top
# block; 6, 7, 8: a pattern set of 2, 4, 8 words), k in {0, 1, 2, 8},
# stop_after in {1, 16, N}, duplicates, rows of fewer than 32 bits; the
# packed carrier's register path (shards up to 2048) and shared path (a
# shard of 2500), the dense carrier's register instances (four warps a
# bank, C = 4, 8, 16; the table in registers at k <= 2) and its rolled
# shared-memory instance (one warp, shards past 2048); against the plain
# mesh, exactly
@pytest.mark.parametrize("packed,banks,fuse,k,stop,b,n,dupes,w", [
    _mesh_case(True, 2, 1, 2, None, 2, 64, False),
    _mesh_case(True, 4, 2, 0, None, 2, 128, True),
    _mesh_case(True, 8, 4, 8, 16, 3, 256, False),
    _mesh_case(True, 2, 4, 1, 1, 2, 96, True),
    _mesh_case(True, 4, 1, 8, None, 1, 200, True),
    _mesh_case(True, 8, 2, 2, None, 2, 128, False),
    _mesh_case(True, 3, 2, 2, 16, 2, 96, False),
    _mesh_case(True, 8, 1, 0, 1, 1, 64, False),
    _mesh_case(True, 4, 4, 2, None, 2, 160, True),
    _mesh_case(True, 2, 2, 8, 16, 1, 5000, False),
    _mesh_case(True, 2, 1, 1, None, 1, 192, False),
    _mesh_case(True, 4, 2, 2, 16, 2, 4096, True),
    _mesh_case(False, 2, 2, 2, None, 2, 128, False),    # C = 4
    _mesh_case(False, 4, 1, 8, None, 2, 160, True),     # table in shared
    _mesh_case(False, 8, 4, 0, 16, 3, 256, False),
    _mesh_case(False, 3, 2, 1, 1, 2, 96, True),
    _mesh_case(False, 2, 2, 2, 16, 2, 2048, False),     # C = 8
    _mesh_case(False, 2, 4, 8, 16, 1, 4096, True),      # C = 16
    _mesh_case(False, 2, 1, 2, 16, 1, 4200, False),     # rolled, 2100
    _mesh_case(False, 4, 2, 1, None, 1, 8400, True),    # rolled, full sort
    _mesh_case(True, 2, 3, 1, None, 2, 96, True),
    _mesh_case(True, 8, 3, 8, 16, 1, 256, False, w=24),
    _mesh_case(True, 3, 5, 0, None, 2, 96, False, w=17),
    _mesh_case(True, 8, 5, 2, 16, 1, 512, True),
    _mesh_case(True, 2, 5, 8, 16, 1, 5000, False),      # shared path
    _mesh_case(True, 2, 6, 8, None, 1, 160, False),
    _mesh_case(True, 3, 6, 1, 1, 2, 96, True),
    _mesh_case(True, 8, 7, 0, 16, 2, 256, False, w=20),
    _mesh_case(True, 2, 7, 2, None, 2, 128, True),
    _mesh_case(True, 8, 8, 1, None, 1, 64, False),
    _mesh_case(True, 2, 8, 2, 16, 1, 5000, True),       # shared path
    _mesh_case(True, 3, 8, 8, 16, 1, 96, False, w=12),
    _mesh_case(False, 2, 3, 2, None, 2, 128, False, w=24),
    _mesh_case(False, 8, 3, 0, 16, 2, 256, True),
    _mesh_case(False, 3, 5, 8, None, 1, 96, False),
    _mesh_case(False, 2, 5, 1, 16, 1, 4200, True),      # rolled
    _mesh_case(False, 8, 6, 2, None, 1, 256, True, w=16),
    _mesh_case(False, 3, 7, 1, 1, 2, 96, False),
    _mesh_case(False, 2, 7, 8, 16, 1, 2048, False),     # C = 8
    _mesh_case(False, 8, 8, 0, None, 2, 64, False),
    _mesh_case(False, 2, 8, 2, 16, 1, 4096, True),      # C = 16
    _mesh_case(False, 4, 8, 1, 16, 1, 8400, False),     # rolled
])
def test_emulated_mesh_kernel_equals_plain_mesh(libs, packed, banks, fuse, k,
                                                stop, b, n, dupes, w):
    x = _rows(b, n, w, dupes, 11 * banks + fuse + k)
    s = n if stop is None else stop
    got, rounds = _mesh(libs["mesh"], x, banks, w, k, s, fuse, packed)
    _same(got, colskip_ref.sort_mesh_ref(torch.from_numpy(x), banks, w, k,
                                         s, packed=packed, fuse=fuse))
    # the kernel's own exchanges stay within the reference's static account
    assert 0 < int(rounds.max()) <= collective_rounds(w, s, fuse)["rounds"]


def test_emulated_mesh_kernel_fuses_rounds(libs):
    # the same rows at fuse 1 to 8: the same outputs, fewer exchanges from
    # 1 to 2 to 4 to 8
    x = _rows(2, 128, 32, False, 5)
    outs, rounds = zip(*(_mesh(libs["mesh"], x, 4, 32, 2, 128, f)
                         for f in range(1, 9)))
    for out in outs[1:]:
        _same(out, outs[0])
    r = [int(t.sum()) for t in rounds]
    assert r[0] > r[1] > r[3] > r[7] > 0


# no round of its own for a load's SL gate: its verdict rides in the round
# that ends the last search, so on a row of distinct values every search
# but the first makes one round less.  A (1, 256) uniform row over 4 banks
# at k = 2 made 1,483 / 1,078 / 858 rounds at F = 1 / 2 / 4 before, 255 of
# them SL-gate rounds; the tally splits the rounds by gate (block, drain:
# none here, every walk ends at a lone element)
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fuse,before,sl", [(1, 1483, 255), (2, 1078, 255),
                                             (4, 858, 255)])
def test_emulated_mesh_rounds_lose_the_sl_gate(libs, packed, fuse, before,
                                              sl):
    lib, n = libs["mesh"], 256
    x = make_dataset("uniform", n, 32, seed=5).astype(np.uint32)[None]
    gates = _mesh_gates(lib)
    got, rounds = _mesh(lib, x, 4, 32, 2, n, fuse, packed)
    _same(got, colskip_ref.sort_mesh_ref(torch.from_numpy(x), 4, 32, 2, n,
                                         packed=packed, fuse=fuse))
    block, drain = gates()
    assert int(rounds[0]) == before - sl == block
    assert drain == 0
    assert int(rounds[0]) <= collective_rounds(32, n, fuse)["rounds"]


# on a row of duplicates a search ends in a drain, whose round carries
# the next load's bits: the rounds are the block and drain rounds, and
# stay exact (a (1, 512) mapreduce row over 4 banks, k = 2)
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("fuse", [1, 2, 4])
def test_emulated_mesh_rounds_by_gate_with_drains(libs, packed, fuse):
    lib, n = libs["mesh"], 512
    x = make_dataset("mapreduce", n, 32, seed=3).astype(np.uint32)[None]
    gates = _mesh_gates(lib)
    got, rounds = _mesh(lib, x, 4, 32, 2, n, fuse, packed)
    _same(got, colskip_ref.sort_mesh_ref(torch.from_numpy(x), 4, 32, 2, n,
                                         packed=packed, fuse=fuse))
    block, drain = gates()
    assert drain > 0 and block > 0
    assert int(rounds[0]) == block + drain
    assert int(rounds[0]) <= collective_rounds(32, n, fuse)["rounds"]


# the chain probe on each round of mesh_exchange.cuh (0 the cluster
# barrier, 1 the async round)
@pytest.mark.parametrize("round_", [0, 1])
@pytest.mark.parametrize("banks", [1, 2, 8])
def test_emulated_mesh_chain_probe(libs, banks, round_):
    out = torch.zeros((1,), dtype=torch.int32)
    assert libs["mesh"].colskip_mesh_chain_launch(out.data_ptr(), 5, 100,
                                                  banks, round_, None) == 0
    acc = 0                           # the chain's words, ORed over banks
    for r in range(100):
        acc += max((((5 >> (r & 31)) ^ acc ^ d) & 1) for d in range(banks))
    assert int(out[0]) == acc
