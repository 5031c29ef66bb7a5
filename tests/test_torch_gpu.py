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
])
def test_colskip_kernel_equals_plain(cuda, b, n, w, k, stop):
    from repro_torch.kernels.colskip import ops, ref
    rng = np.random.default_rng(n + k)
    x = torch.from_numpy(rng.integers(0, 1 << w, (b, n), dtype=np.uint64)
                         .astype(np.uint32)).to(cuda)
    before = ops.launches
    got = ops.colskip_sort_batched(x, w, k, stop_after=stop)
    assert ops.launches == before + 1
    want = ref.sort_ref(x, w, k, stop)
    torch.cuda.synchronize()
    for g, v in zip(got, want):
        assert g.dtype == v.dtype and g.device.type == "cuda"
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
    assert ops.launches == before
