"""The port's CUDA kernels on the card (marked ``gpu``; skipped without one).

Run on a machine with the card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain torch version on the same device,
exactly, and the engine on ``cuda`` reproduces the golden telemetry of
tests/golden/continuous_telemetry.json through both kernels.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _words(t):
    from repro_torch.core.bitmatrix import as_words
    return as_words(t.cpu())


@pytest.mark.parametrize("b,n,w,k,stop", [
    (8, 64, 32, 2, None), (3, 100, 16, 0, None), (5, 256, 32, 4, 17),
    (8, 2048, 32, 2, 16), (2, 4096, 32, 2, 64), (1, 33, 8, 8, None),
    # the register path (WPL 1 and 2) and the shared one (WPL 4 to 32),
    # k in {0, 1, 2, 8}, stop_after in {1, 16, N}, ragged B
    (5, 1024, 32, 1, None), (3, 2048, 32, 8, 1), (7, 1500, 32, 0, None),
    (2, 2100, 32, 8, None), (3, 32768, 32, 2, 16), (2, 32768, 32, 0, 1),
    (9, 3000, 24, 1, 16),
])
def test_colskip_kernel_equals_plain(cuda, b, n, w, k, stop):
    from repro_torch.kernels.colskip import ops, ref
    rng = np.random.default_rng(n + k)
    x = rng.integers(0, 1 << w, (b, n), dtype=np.uint64).astype(np.uint32)
    x[0] %= 5                                  # duplicate-heavy drains
    x = torch.from_numpy(x).to(cuda)
    before = ops.launches
    got = ops.colskip_sort_batched(x, w, k, stop_after=stop)
    assert ops.launches == before + 1
    # the plain machine runs on the host (on the card it is launch-bound)
    want = ref.sort_ref(x.cpu(), w, k, stop)
    torch.cuda.synchronize()
    for g, v in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == v.dtype
        assert torch.equal(_words(g), _words(v))


@pytest.mark.parametrize("name", ["clustered", "kruskal", "mapreduce",
                                  "normal", "uniform"])
def test_colskip_kernel_equals_plain_over_datasets(cuda, name):
    from repro_torch.core.datasets import DATASETS, make_dataset
    from repro_torch.kernels.colskip import ops, ref
    assert name in DATASETS
    x = np.stack([make_dataset(name, 512, 32, seed=s)
                  for s in range(3)]).astype(np.uint32)
    got = ops.colskip_sort_batched(torch.from_numpy(x).to(cuda), 32, 2)
    want = ref.sort_ref(torch.from_numpy(x), 32, 2)
    for g, v in zip(got, want):
        assert torch.equal(_words(g), _words(v))


@pytest.mark.parametrize("b,n,k", [(8, 128, 8), (13, 1000, 5),
                                   (8, 16384, 100), (3, 64, 64)])
def test_radix_kernel_equals_plain(cuda, b, n, k):
    from repro_torch.core.bitmatrix import to_uint32
    from repro_torch.core.topk import to_sortable_uint
    from repro_torch.kernels.radix_topk import ops, ref
    rng = np.random.default_rng(b + n + k)
    x = (rng.normal(size=(b, n)) * 10).astype(np.float32)
    x[1] = np.float32(-1.0)
    xf = torch.from_numpy(x).to(cuda)
    u = to_sortable_uint(xf)
    want = ref.threshold_ref(u, k)
    for got in (ops.threshold_f32(xf, k),
                ops.threshold_sortable(to_uint32(u), k)):
        for g, v in zip(got, want):
            assert torch.equal(_words(g), _words(v))
    v1, i1 = ops.radix_topk(xf, k)
    v2, i2 = ops.radix_topk(xf.cpu(), k, device="cpu")
    assert torch.equal(v1.cpu(), v2) and torch.equal(i1.cpu(), i2)


def test_engine_on_cuda_reproduces_golden(cuda):
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.sortserve import EngineConfig, SortServeEngine
    from _torch_golden import GOLDEN, GOLDEN_CFG, golden_payload, \
        golden_text
    c0, r0 = colskip_ops.launches, radix_ops.launches
    engine = SortServeEngine(EngineConfig(**GOLDEN_CFG, device="cuda"))
    live = golden_text(golden_payload(engine))
    assert live.strip() == GOLDEN.read_text().strip()
    assert colskip_ops.launches > c0 and radix_ops.launches > r0


def test_vote_chain_probe_runs_uncounted(cuda):
    from repro_torch.kernels.colskip import ops
    before = ops.launches
    out = ops.vote_chain(1000)
    torch.cuda.synchronize()
    assert out.shape == (1,) and 0 <= int(out[0]) <= 1000
    # the first 5 bits of the lane index differ across lanes, so the vote
    # on each of them is true whatever the running count
    assert int(out[0]) >= 5 * (1000 // 32)
    out = ops.redux_chain(1000)
    torch.cuda.synchronize()
    assert 5 * (1000 // 32) <= int(out[0]) <= 1000
    assert ops.launches == before


@pytest.mark.parametrize("b,n", [
    (3, 64), (5, 256), (2, 1024), (7, 128), (4, 1), (3, 2),
    (3, 1 << 15), (5, 1 << 16), (2, 1 << 20), (13, 4096),
    # one block, then clusters of 2 to 8 blocks, then cluster + global
    (3, 1 << 11), (5, 1 << 12), (3, 1 << 13), (9, 1 << 14), (4, 8),
])
def test_bitonic_kernel_equals_plain(cuda, b, n):
    from repro_torch.kernels.bitonic import ops, ref
    rng = np.random.default_rng(b + n)
    x = rng.integers(0, 1 << 32, (b, n), dtype=np.uint64).astype(np.uint32)
    if n == 4096:
        x %= 7                                 # duplicate-heavy rows
    xt = torch.from_numpy(x).to(cuda)
    before = ops.launches
    got = ops.bitonic_sort(xt)
    assert ops.launches == before + 1
    want = ref.sort_ref(xt)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint32 and got.device.type == "cuda"
    assert torch.equal(_words(got), _words(want))
    assert np.array_equal(_words(got).numpy(), np.sort(x, -1))


def test_bitonic_kernel_refuses_a_width_not_a_power_of_two(cuda):
    from repro_torch.kernels.bitonic import ops
    with pytest.raises(ValueError, match="power-of-two"):
        ops.bitonic_sort(torch.zeros((2, 96), dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("b,n,w,k,stop", [
    (8, 64, 32, 2, None), (3, 100, 16, 0, None), (5, 256, 32, 4, 17),
    (8, 2048, 32, 2, 16), (2, 4096, 32, 2, 64), (1, 33, 8, 8, None),
    (4, 1024, 32, 2, None), (3, 17, 16, 1, 7),
])
def test_dense_kernel_equals_packed_kernel_and_plain(cuda, b, n, w, k, stop):
    from repro_torch.kernels.colskip import ops, ref
    rng = np.random.default_rng(n + k + 1)
    x = rng.integers(0, 1 << w, (b, n), dtype=np.uint64).astype(np.uint32)
    x[0] %= 5                                  # duplicate-heavy drains
    x = torch.from_numpy(x).to(cuda)
    before = (ops.launches, ops.launches_dense)
    dense = ops.colskip_sort_batched(x, w, k, stop_after=stop, packed=False)
    assert (ops.launches, ops.launches_dense) == (before[0], before[1] + 1)
    packed = ops.colskip_sort_batched(x, w, k, stop_after=stop)
    want = ref.sort_ref(x, w, k, stop, packed=False) if n <= 256 else packed
    torch.cuda.synchronize()
    for d, p, v in zip(dense, packed, want):
        assert d.dtype == p.dtype and d.device.type == "cuda"
        assert torch.equal(_words(d), _words(p))
        assert torch.equal(_words(d), _words(v))


def test_dense_kernel_refuses_rows_past_its_shared_memory(cuda):
    from repro_torch.kernels.colskip import ops
    for k in (0, 2, 8):
        widest = ops.max_n(False, k)
        assert 2048 <= widest < 1 << 16
        x = torch.zeros((1, widest + 32), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="dense"):
            ops.colskip_sort_batched(x, 32, k, packed=False)
    assert ops.max_n(False, 8) < ops.max_n(False, 2) <= ops.max_n(False, 0)


def test_engine_on_cuda_dense_reproduces_golden(cuda):
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.sortserve import EngineConfig, SortServeEngine
    from _torch_golden import GOLDEN, GOLDEN_CFG, golden_payload, \
        golden_text
    c0, d0 = colskip_ops.launches, colskip_ops.launches_dense
    engine = SortServeEngine(EngineConfig(**GOLDEN_CFG, packed=False,
                                          device="cuda"))
    live = golden_text(golden_payload(engine))
    assert live.strip() == GOLDEN.read_text().strip()
    assert colskip_ops.launches == c0 and colskip_ops.launches_dense > d0
