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


@pytest.mark.parametrize("b,n,k", [(1, 65536, 50), (3, 20000, 20000),
                                   (9, 16385, 1)])
def test_radix_kernel_streams_wide_sortable_rows(cuda, b, n, k):
    # rows past the kernel's shared memory re-read device memory each pass
    from repro_torch.kernels.radix_topk import ops, ref
    assert n > ops.smem_n()
    rng = np.random.default_rng(b + n)
    u = rng.integers(0, 1 << 32, (b, n), dtype=np.uint64).astype(np.uint32)
    u[-1] = 5                                  # a constant row
    got = ops.threshold_sortable(torch.from_numpy(u).to(cuda), k)
    want = ref.threshold_ref(torch.from_numpy(u), k)
    for g, v in zip(got, want):
        assert torch.equal(_words(g), _words(v))


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
    # every register instance (C = 4, 8, 16 elements a thread) with the
    # table in registers (k <= 2) and in shared memory, the rolled one
    (3, 500, 32, 8, None), (2, 1000, 32, 8, 16), (5, 2000, 32, 1, None),
    (2, 1900, 32, 8, 1), (3, 2100, 32, 0, None), (2, 6000, 32, 8, 16),
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


@pytest.mark.parametrize("packed,banks,fuse,b,n,k,stop", [
    (True, 2, 1, 8, 256, 2, None), (True, 4, 2, 8, 1024, 0, 16),
    (True, 8, 4, 3, 2048, 8, None), (True, 4, 4, 8, 8192, 2, None),
    (True, 8, 2, 2, 65536, 2, 16), (True, 3, 2, 5, 96, 1, 1),
    (True, 2, 2, 2, 4096 + 2048, 8, 16),   # shards past the register path
    (False, 2, 1, 8, 256, 2, None), (False, 4, 2, 8, 1024, 8, 16),
    (False, 8, 4, 3, 16384, 2, 16), (False, 4, 2, 2, 4096, 0, None),
    (False, 2, 2, 2, 4096 + 2048, 2, 16),  # the rolled dense instance
])
def test_mesh_kernel_equals_local_kernel_and_plain_mesh(cuda, packed, banks,
                                                        fuse, b, n, k, stop):
    from repro_torch.dist.bankmesh import collective_rounds
    from repro_torch.kernels.colskip import ops, ref
    rng = np.random.default_rng(banks * n + k)
    x = rng.integers(0, 1 << 32, (b, n), dtype=np.uint64).astype(np.uint32)
    x[0] %= 5                                  # duplicate-heavy drains
    xt = torch.from_numpy(x).to(cuda)
    before = (ops.launches, ops.launches_mesh, ops.launches_mesh_dense)
    got = ops.colskip_sort_mesh_batched(xt, banks, 32, k, stop_after=stop,
                                        packed=packed, fuse=fuse,
                                        return_rounds=True)
    assert (ops.launches, ops.launches_mesh, ops.launches_mesh_dense) == (
        before[0], before[1] + packed, before[2] + (not packed))
    # past the local kernel's widest row the host's plain machine holds it
    local = (ops.colskip_sort_batched(xt, 32, k, stop_after=stop)
             if n <= ops.max_n(True, k)
             else ref.sort_ref(torch.from_numpy(x), 32, k, stop))
    torch.cuda.synchronize()
    for g, v in zip(got[:4], local):
        assert g.device.type == "cuda" and g.dtype == v.dtype
        assert torch.equal(_words(g), _words(v))
    s = n if stop is None else stop
    assert 0 < int(got[4].max()) <= collective_rounds(32, s, fuse)["rounds"]
    if n <= 256:       # the plain mesh on the host (launch-bound on the card)
        want = ref.sort_mesh_ref(torch.from_numpy(x), banks, 32, k, s,
                                 packed=packed, fuse=fuse)
        for g, v in zip(got[:4], want):
            assert torch.equal(_words(g), _words(v))


def test_mesh_kernel_refuses_what_it_is_not_built_for(cuda):
    from repro_torch.kernels.colskip import ops
    x = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    for packed in (True, False):
        with pytest.raises(NotImplementedError, match="fuse"):
            ops.colskip_sort_mesh_batched(x, 4, fuse=3, packed=packed)
        wide = ops.mesh_shard_max(packed, 2) * 2 + 64
        with pytest.raises(ValueError, match="shard"):
            ops.colskip_sort_mesh_batched(
                torch.zeros((1, wide), dtype=torch.int32, device=cuda), 2,
                packed=packed)
    with pytest.raises(ValueError, match="banks"):
        ops.colskip_sort_mesh_batched(torch.zeros((1, 90), dtype=torch.int32,
                                                  device=cuda), 9)
    assert ops.mesh_shard_max(False, 8) < ops.mesh_shard_max(False, 2)


def test_mesh_chain_probe_runs_uncounted(cuda):
    from repro_torch.kernels.colskip import ops
    before = ops.launches_mesh
    out = ops.mesh_chain(1000, 4)
    torch.cuda.synchronize()
    assert int(out[0]) == 1000       # banks 0 and 1 post opposite words
    assert ops.launches_mesh == before


@pytest.mark.parametrize("packed", [True, False])
def test_engine_on_cuda_mesh_reproduces_golden(cuda, packed):
    from repro_torch.kernels.colskip import ops as colskip_ops
    from repro_torch.sortserve import EngineConfig, SortServeEngine
    from _torch_golden import GOLDEN, GOLDEN_CFG, golden_payload, \
        golden_text
    cfg = {**GOLDEN_CFG, "backends": tuple(
        "colskip_mesh" if b == "colskip" else b
        for b in GOLDEN_CFG["backends"])}
    m0 = colskip_ops.launches_mesh + colskip_ops.launches_mesh_dense
    engine = SortServeEngine(EngineConfig(**cfg, mesh=True, fuse=2,
                                          packed=packed, device="cuda"))
    payload = golden_payload(engine)
    for r in payload["responses"]:
        if r["backend"] == "colskip_mesh":
            r["backend"] = "colskip"
    assert golden_text(payload).strip() == GOLDEN.read_text().strip()
    assert colskip_ops.launches_mesh + colskip_ops.launches_mesh_dense > m0


def test_mesh_double_buffer_stages_on_a_side_stream(cuda):
    # six whole-pool tiles at vt 0: each admit after the first stages its
    # successor's host-to-device copy; the successor runs on it
    from repro_torch.sortserve import EngineConfig, SortServeEngine
    from repro_torch.sortserve.batcher import Tile
    eng = SortServeEngine(EngineConfig(
        backends=("colskip_mesh",), mesh=True, mesh_hosts=2, fuse=2,
        tile_rows=4, min_bucket=8, banks=4, bank_width=64, bank_rows=4,
        sim_width_cap=4096, cache_size=0, device="cuda"))
    rng = np.random.default_rng(5)
    tiles = [Tile(op="sort", data=rng.integers(0, 1 << 32, (4, 256),
                                               dtype=np.uint64)
                  .astype(np.uint32), k=None, entries=[], pad_rows=4)
             for _ in range(6)]
    out = {}
    eng.scheduler.feed(tiles, eng._execute, at=0.0,
                       sink=lambda t, res, exc: out.update({id(t): res}))
    eng.scheduler.pump()
    coll = eng.telemetry()["collectives"]
    assert (coll["prefetch_staged"], coll["prefetch_hits"]) == (4, 4)
    for t in tiles:
        assert np.array_equal(out[id(t)].values, np.sort(t.data, -1))


# ---------------------------------------------------------------- models

MODEL_ARCHS = ["gemma3-4b", "command-r-35b", "deepseek-coder-33b",
               "qwen1.5-32b", "granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
               "rwkv6-1.6b", "hymba-1.5b", "whisper-tiny", "qwen2-vl-7b"]


@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_smoke_cuda_equals_cpu(cuda, no_tf32, arch):
    """One seeded CPU model and its copy on the card, float32 with TF32
    off: prefill and 3 decode steps, logits and every leaf of the state or
    cache, within 1e-4 + 1e-4 |x| (cuBLAS and
    F.scaled_dot_product_attention sum in other orders than the host's
    einsums); the router's expert ids on the card equal the host's on the
    same probabilities; for the families that warm up token by token, the
    warm-up's last logits on the card equal prefill's."""
    import copy
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.radix_topk import radix_topk
    from repro_torch.models import api, moe
    from repro_torch.serve.engine import WARM_FAMILIES
    cfg = get_config(arch, smoke=True)
    cpu = api.init(cfg, seed=0, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    b, s, n = 2, 40, 3                  # past the smoke window of 32
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(b, cfg.enc_ctx, cfg.d_model)).astype(np.float32))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (n, b, 1)))
    probs = []
    route = moe._route

    def spy(cfg_, router, xf):
        out = route(cfg_, router, xf)
        if xf.is_cuda:
            probs.append((out[2], out[1]))
        return out

    outs = {}
    moe._route = spy
    try:
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            lg, cache = api.prefill(cfg, model, batch)
            got = [lg] + [cache[kk] for kk in sorted(cache)]
            cache = {kk: F.pad(vv, (0, 0, 0, 0, 0, n))
                     if kk in ("k", "v") else vv for kk, vv in cache.items()}
            for i in range(n):
                lg, cache = api.decode_step(cfg, model, steps[i], cache, s + i)
                got += [lg] + [cache[kk].clone() for kk in sorted(cache)]
            outs[dev] = [g.cpu() for g in got]
            if cfg.family in WARM_FAMILIES and dev == "cuda":
                pl = api.prefill(cfg, model, batch)[0]
                cache = api.init_cache(cfg, b, s, model=model, device=cuda,
                                       frames=batch.get("frames"))
                for i in range(s):
                    lg, cache = api.decode_step(
                        cfg, model, batch["tokens"][:, i:i + 1], cache, i)
                torch.testing.assert_close(lg, pl, rtol=1e-4, atol=1e-4)
    finally:
        moe._route = route
    assert len(outs["cuda"]) == len(outs["cpu"])
    for a, c in zip(outs["cuda"], outs["cpu"]):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
    assert len(probs) == (0 if cfg.moe is None else cfg.n_layers * (1 + n))
    for p, ids in probs:
        want = radix_topk(p.cpu(), cfg.moe.top_k, device="cpu")[1]
        assert torch.equal(ids.cpu(), want)


@pytest.mark.parametrize("s,window", [(40, 0), (40, 7), (2048, 300)])
def test_fused_attention_equals_plain_on_the_card(cuda, no_tf32, s, window):
    """F.scaled_dot_product_attention (causal, windowed, decode over the
    cache's valid slice) against the plain sdpa on the same card tensors;
    every query sees its own key, so no row is NaN."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    cfg = get_config("gemma3-4b", smoke=True)
    g = torch.Generator(device=cuda).manual_seed(s + window)
    q = torch.randn(1, s, 4, 16, generator=g, device=cuda)
    k = torch.randn(1, s, 2, 16, generator=g, device=cuda)
    v = torch.randn(1, s, 2, 16, generator=g, device=cuda)
    got = blocks.attend(q, k, v, window, cfg)
    mask = blocks.causal_mask(s, s, window or None, device=cuda)
    torch.testing.assert_close(got, blocks.sdpa(q, k, v, mask, cfg),
                               rtol=1e-4, atol=1e-4)
    for cache_len in (0, s // 2, s - 1):
        w = window or s + 1
        got = blocks._attend_cache(cfg, q[:, :1], k, v, cache_len, w)
        kpos = torch.arange(s, device=cuda)
        valid = (kpos <= cache_len) & (kpos > cache_len - w)
        want = blocks.sdpa(q[:, :1], k, v, valid[None, None, None, None],
                           cfg)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["gemma3-4b", "granite-moe-3b-a800m",
                                  "rwkv6-1.6b", "hymba-1.5b", "whisper-tiny",
                                  "qwen2-vl-7b"])
def test_generate_on_the_card_repeats(cuda, arch):
    from repro_torch.configs import get_config
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.models import api
    from repro_torch.serve import generate
    cfg = get_config(arch, smoke=True)
    model = api.init(cfg, seed=0, device=cuda)
    prompts = torch.ones((2, 40), dtype=torch.int32, device=cuda)
    frames = (torch.randn((2, cfg.enc_ctx, cfg.d_model), device=cuda,
                          generator=torch.Generator(device=cuda).manual_seed(4))
              if cfg.family == "encdec" else None)
    before = radix_ops.launches
    runs = [generate(cfg, model, prompts, max_new_tokens=8, top_k=16,
                     top_p=0.9, frames=frames,
                     generator=torch.Generator(device=cuda).manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert (runs[0] < cfg.vocab).all()
    routers = (1 + 8) * cfg.n_layers if cfg.moe is not None else 0
    assert radix_ops.launches - before == 2 * (routers + 8)
