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


def test_radix_fused_topk_equals_plain_at_the_router_rows(cuda):
    # the narrow instance's fused top-k entry at the train step's router
    # rows: one launch, values bit for bit and indices equal to the plain
    # threshold + exact-k mask + compaction on the card and on the host
    from repro_torch.kernels.radix_topk import ops
    rng = np.random.default_rng(40)
    p = torch.softmax(torch.from_numpy(
        rng.normal(size=(8192, 40)).astype(np.float32)), -1)
    p[::7, :4] = p[::7, 4:8]                   # ties at the threshold
    x = p.to(cuda)
    before = dict(ops.instance_launches)
    vals, idxs = ops.fused_topk(x, 8)
    assert ops.instance_launches["narrow"] == before["narrow"] + 1
    for want_v, want_i in (ops._plain_topk(x, 8), ops.radix_topk(p, 8,
                                                                 device="cpu")):
        assert torch.equal(vals.view(torch.int32).cpu(),
                           want_v.view(torch.int32).cpu())
        assert torch.equal(idxs.cpu(), want_i.cpu())
    assert torch.equal(ops.radix_topk(x, 8)[1], idxs)


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


@pytest.mark.parametrize("b,n,k,kmin", [(8, 4096, 32, False),
                                        (8, 300, 17, True),
                                        (13, 1024, 64, True),
                                        (3, 20000, 64, True),
                                        (1, 40000, 30000, False)])
def test_radix_sort_serving_tile_is_one_launch(cuda, b, n, k, kmin):
    # the radix backend's tile body on the card: one launch of the fused
    # top-k entry (kmin on the complement, plane reads, one packed
    # buffer), equal to its plain version on the host; at k = 30,000 the
    # streamed row's slots live in its output row
    from repro_torch.kernels.radix_topk import ops
    from repro_torch.sortserve.backends import _radix_select
    rng = np.random.default_rng(n + k)
    x = rng.integers(0, 1 << 32, (b, n), dtype=np.uint64).astype(np.uint32)
    x[0] %= 9                                  # ties at the threshold
    before = ops.launches
    got = _radix_select(x, k, kmin, cuda)
    assert ops.launches == before + 1
    want = _radix_select(x, k, kmin, torch.device("cpu"))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("b,v,k", [(4, 49408, 16), (2, 152064, 64),
                                   (1, 262144, 64), (3, 20000, 600)])
def test_radix_sampler_call_is_two_launches(cuda, b, v, k):
    # a vocab row past MAX_N: the banks read in place by one launch, then
    # the manager pass with their indices as its payload (k = 600: on the
    # block instance), equal to the plain radix_topk on the host
    from repro_torch.kernels.radix_topk import ops
    rng = np.random.default_rng(v + k)
    x = rng.normal(size=(b, v)).astype(np.float32)
    x[:, -40:] = x[:, :40]                     # ties across banks
    before = ops.launches
    vals, idxs = ops.radix_topk(torch.from_numpy(x).to(cuda), k)
    assert ops.launches == before + 2
    want_v, want_i = ops.radix_topk(torch.from_numpy(x), k, device="cpu")
    assert torch.equal(vals.view(torch.int32).cpu(),
                       want_v.view(torch.int32))
    assert torch.equal(idxs.cpu(), want_i)


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
    from repro_torch.kernels.colskip import ops, ref
    x = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    rows = np.random.default_rng(3).integers(0, 1 << 32, (2, 96),
                                             dtype=np.uint64).astype(np.uint32)
    for packed in (True, False):
        # the reference's range: fuse 0 and 9 refused, 3 and 8 run
        for bad in (0, 9):
            with pytest.raises(ValueError, match="fuse"):
                ops.colskip_sort_mesh_batched(x, 4, fuse=bad, packed=packed)
        for fuse in (3, 8):
            got = ops.colskip_sort_mesh_batched(
                torch.from_numpy(rows).to(cuda), 3, fuse=fuse, packed=packed)
            want = ref.sort_mesh_ref(torch.from_numpy(rows), 3, fuse=fuse,
                                     packed=packed)
            for g, v in zip(got, want):
                assert torch.equal(_words(g), _words(v))
        wide = ops.mesh_shard_max(packed, 2) * 2 + 64
        with pytest.raises(ValueError, match="shard"):
            ops.colskip_sort_mesh_batched(
                torch.zeros((1, wide), dtype=torch.int32, device=cuda), 2,
                packed=packed)
    with pytest.raises(ValueError, match="banks"):
        ops.colskip_sort_mesh_batched(torch.zeros((1, 90), dtype=torch.int32,
                                                  device=cuda), 9)
    assert ops.mesh_shard_max(False, 8) < ops.mesh_shard_max(False, 2)


# on each round of mesh_exchange.cuh (ops.MESH_ROUNDS_BUILT)
@pytest.mark.parametrize("round_", ["barrier", "async"])
def test_mesh_chain_probe_runs_uncounted(cuda, round_):
    from repro_torch.kernels.colskip import ops
    before = ops.launches_mesh
    out = ops.mesh_chain(1000, 4, round=round_)
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


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_train_step_on_the_card_matches_cpu(cuda, no_tf32, arch):
    """One seeded CPU train state and its copy on the card, float32 with
    TF32 off, one ``make_train_step``: loss, grad norm and every grad leaf
    within 1e-4 (the grads of a leaf's largest magnitude), the router's
    calls twice a layer (forward and remat recompute), each call's expert
    ids equal to the host's on the same probabilities."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.kernels.radix_topk import radix_topk
    from repro_torch.launch.train import make_batch
    from repro_torch.models import moe
    from repro_torch.train import adamw_init, init_state, make_train_step
    cfg = get_config(arch, smoke=True)
    tokens = SyntheticCorpus(cfg.vocab, 32, 2, seed=0).batch(0)["tokens"]
    cpu = init_state(cfg, seed=0, device="cpu")
    model = copy.deepcopy(cpu["model"]).to(cuda)
    gpu = {"model": model, "opt": adamw_init(model.named_parameters())}
    calls = []
    route = moe.radix_topk

    def spy(x, k, **kw):
        out = route(x, k, **kw)
        if x.is_cuda:
            calls.append((x.cpu(), out[1].cpu()))
        return out

    got = {}
    moe.radix_topk = spy
    try:
        for where, state in (("cpu", cpu), ("cuda", gpu)):
            grads = {}

            def capture(g, _state, grads=grads):
                grads.update({n: t.float().cpu() for n, t in g.items()})
                return g, {}

            before = radix_ops.launches
            _, m = make_train_step(cfg, peak_lr=1e-3, warmup=0,
                                   grad_reduce=capture)(
                state, make_batch(cfg, tokens, state["model"].device))
            got[where] = ({k: float(v) for k, v in m.items()}, grads,
                          radix_ops.launches - before)
    finally:
        moe.radix_topk = route
    (mc, gc, _), (mg, gg, launches) = got["cpu"], got["cuda"]
    for k in mc:
        assert np.isfinite(mg[k])
        assert mg[k] == pytest.approx(mc[k], rel=1e-4, abs=1e-4), k
    for n, c in gc.items():
        assert torch.isfinite(gg[n]).all()
        assert float((gg[n] - c).abs().max()) <= 1e-4 * float(c.abs().max())
    routers = 2 * cfg.n_layers if cfg.moe is not None else 0
    assert len(calls) == launches == routers
    for x, ids in calls:
        assert torch.equal(radix_topk(x, cfg.moe.top_k, device="cpu")[1], ids)


# ---------------------------------------------------------------- distribution
# ranks that share the card join gloo (NCCL refuses two ranks on one card)
# and stage their collectives through the host; tests/_torch_dist_ranks.py
# holds the rank bodies the CPU tests run against the JAX package

DIST_DEVICE = "cuda:0"


def _ranks(case, inp):
    import _torch_dist_ranks as R
    return R.run_case(case, inp, device=DIST_DEVICE)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max()) / max(
        float(np.abs(b).max()), 1e-30)


def test_distsort_ranks_on_the_card(cuda):
    """8 and 4 banks on the card: thresholds and minima equal numpy's,
    masks equal one rank's ``topk_mask`` on the whole row."""
    from _torch_dist_ranks import distsort_inputs
    from repro_torch.core.topk import topk_mask
    inp = distsort_inputs()
    port = _ranks("distsort", inp)
    for name in ("x", "ties"):
        want = topk_mask(torch.as_tensor(inp[name]), 13).numpy()
        for key in ("_mask8", "_mask8t"):
            got = np.concatenate([p[name + key] for p in port], -1)
            assert np.array_equal(got, want)
    for j, (u, ks) in enumerate(zip(inp["trials"], inp["trial_ks"])):
        for p in port:
            for k in ks:
                assert np.array_equal(p[f"t{j}_kth{k}"],
                                      np.sort(u, axis=-1)[:, -k])
            assert np.array_equal(p[f"t{j}_min"], u.min(-1))
        mask = np.concatenate([p[f"t{j}_mask5"] for p in port[:4]], -1)
        k = min(5, u.shape[-1])
        assert np.array_equal(mask, topk_mask(torch.as_tensor(u), k).numpy())


def test_compress_pipeline_and_meshes_on_the_card(cuda):
    """ef_topk_psum (and _tree) against the one-process oracle, the
    ratio-1.0 schedule against the pmean, the pipeline against its stages
    one after another (1e-5, TF32 off), the collectives over two axes."""
    from _torch_dist_ranks import compress_inputs, topk_oracle
    inp = compress_inputs()
    port = _ranks("compress", inp)
    cat = lambda key: np.concatenate([p[key] for p in port])   # noqa: E731
    g = inp["g"]
    red, errs = topk_oracle(np.split(g, 4), 16)
    assert np.array_equal(cat("err"), np.concatenate(errs))
    np.testing.assert_allclose(port[0]["red"], red, rtol=0, atol=1e-6)
    assert np.array_equal(cat("auto_one_red") / 4.0, cat("pmean"))
    assert not cat("auto_one_err").any()
    assert float(port[0]["auto_hot_ratio"]) > 0.25
    for path in ("a", "b.c"):
        cs = [(_leaf(inp["tree_g"][r], path) + _leaf(inp["tree_e"][r], path))
              .ravel() for r in range(4)]
        red, errs = topk_oracle(cs, round(0.1 * 4 * cs[0].size))
        for r, p in enumerate(port):
            assert np.array_equal(p[f"tree_err.{path}"].ravel(), errs[r])
            np.testing.assert_allclose(p[f"tree_red.{path}"].ravel(), red,
                                       rtol=0, atol=1e-6)
    want = inp["xs"]
    for i in range(4):
        want = np.tanh(want @ inp["ws"][i])
    for r, p in enumerate(port):
        np.testing.assert_allclose(p["pipeline"], want, rtol=0, atol=1e-5)
        assert p["gather_md"].ravel().tolist() == [1.0, 3.0, 2.0, 4.0]
        assert p["pmax_both"].tolist() == [4.0]


def _leaf(tree, path):
    for key in path.split("."):
        tree = tree[key]
    return tree


def test_dp_train_on_the_card(cuda):
    """make_dp_train_step on 4 ranks on the card: ratio 1.0 equals the
    plain pmean step, the plain step equals one replica on the whole batch
    (1e-5 of each leaf's largest value), the grads the optimizer got equal
    the mean of the shards' grads taken on the CPU (1e-5) and their norm
    that mean's, 0.05 trains with a residual, and the tree's residuals
    equal the one-process oracle's.  Each step runs its own backward, and
    the card's attention backward adds in a varying order, so the grads
    of two steps are held within 1e-5, not bit for bit."""
    from _torch_dist_ranks import (_flat, dp_train_inputs_from_port,
                                   topk_oracle)
    inp = dp_train_inputs_from_port()
    port = _ranks("dp_train", inp)
    grads = [_flat(g) for g in inp["grads"]]
    mean = {k: np.mean([g[k] for g in grads], axis=0, dtype=np.float64)
            for k in grads[0]}
    mean_norm = float(np.sqrt(sum(np.sum(g * g) for g in mean.values())))
    for p in port:
        assert p["comp_ef_max"] == 0.0
        for k, want in p["plain_params"].items():
            assert _rel(p["comp_params"][k], want) <= 1e-6, k
            assert _rel(want, p["one_params"][k]) <= 1e-5, k
        for k, want in mean.items():
            assert _rel(p["plain_grads"][k], want) <= 1e-5, k
            assert _rel(p["comp_grads"][k], p["plain_grads"][k]) <= 1e-5, k
            assert _rel(p["plain_grads"][k], p["one_grads"][k]) <= 1e-5, k
        for tag in ("plain", "comp", "one"):
            assert abs(p[f"{tag}_gnorm"] - mean_norm) <= 1e-5 * mean_norm
        assert all(np.isfinite(p["sparse_losses"])) and p["sparse_finite"]
        assert p["sparse_ef_energy"] > 0.0
    for path in grads[0]:
        cs = [grads[r][path].astype(np.float32).ravel() for r in range(4)]
        red, errs = topk_oracle(cs, round(0.05 * 4 * cs[0].size))
        for r, p in enumerate(port):
            assert np.array_equal(p[f"tree1_err.{path}"].ravel(), errs[r])
            np.testing.assert_allclose(p[f"tree1_red.{path}"].ravel(), red,
                                       rtol=0, atol=1e-6)


def test_moe_ep_on_the_card(cuda):
    """The expert-parallel MoE on a (data 2, model 4) mesh of 8 ranks on
    the card against the auto path (2e-5, TF32 off), whether a rank holds
    every expert or its own; granite-moe's greedy tokens on a (2, 2) mesh
    equal one rank's, and the model ranks of a data row sample alike."""
    from _torch_dist_ranks import moe_ep_inputs, qwen_ep_cfg
    from repro_torch.models import moe
    cfg = qwen_ep_cfg()
    gen = torch.Generator().manual_seed(0)
    params = {k: v.numpy() for k, v in moe.moe_params(cfg, gen, "cpu").items()}
    port = _ranks("moe_ep", moe_ep_inputs(params))
    for m in range(4):
        rows = sorted((p["data"], p) for p in port if p["model"] == m)
        y = np.concatenate([p["y"] for _, p in rows])
        np.testing.assert_allclose(y, port[0]["y_auto"], rtol=0, atol=2e-5)
        assert all(np.array_equal(p["y"], p["y_held"]) for _, p in rows)
    in_mesh = [p for p in port if "greedy" in p]
    one = port[0]["greedy_one"]
    for r, p in enumerate(in_mesh):
        assert np.array_equal(p["greedy"], one[2 * (r // 2):2 * (r // 2) + 2])
    for d in range(2):
        assert np.array_equal(in_mesh[2 * d]["sampled"],
                              in_mesh[2 * d + 1]["sampled"])
