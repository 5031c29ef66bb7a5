"""The port's bank mesh (``repro_torch.dist.bankmesh``) on the CPU.

  * the plain mesh — the §III machine on bank-stacked column shards with
    the §IV gates between the banks — equals the JAX ``colskip_machine``
    run (without ``shard_map``, which fails under the installed jax) with
    the same bank-stacked hooks written in jnp: per-bank sorted masks,
    positions, CRs and drains, bit for bit;
  * its assembled outputs equal the reference's local
    ``colskip_sort_batched`` (Pallas, interpret mode) and the port's plain
    machine (values, order, CRs, cycles) and ``multibank_colskip_sort``'s
    cycles, across the paper's datasets, D in {1, 2, 4, 8}, both carriers,
    fuse in {1, 2, 4}, k in {0, 2} and stop_after;
  * ``collective_rounds`` equals the reference's;
  * the two parity bodies of ``tests/test_bankmesh.py`` (which fail there
    under jax 0.9.0: ``shard_map`` rejects the machine's ``fori_loop``)
    run in process on the port's 4-bank plain mesh: responses,
    ``cycles_exact``, ``column_reads``, the ``scheduler`` section, the
    fuse sweep's ``collectives`` and the double-buffer prefetch counts;
  * ``MeshBankPool`` geometry, the kmin early exit, the topology
    fingerprint's launcher-cache hit and the argument checks.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multibank_colskip_sort
from repro.dist.bankmesh import collective_rounds as ref_collective_rounds
from repro.kernels.colskip import colskip_sort_batched as ref_sort_batched
from repro.kernels.colskip.kernel import colskip_machine as jax_machine
from repro_torch.core.datasets import DATASETS, make_dataset
from repro_torch.dist.bankmesh import (
    MeshBankPool,
    collective_rounds,
    colskip_sort_mesh,
    make_bank_mesh,
    topology_fingerprint,
)
from repro_torch.kernels.colskip import ops
from repro_torch.kernels.colskip.ref import (
    bank_hooks,
    colskip_machine,
    sort_mesh_ref,
    sort_ref,
)
from repro_torch.launch.sortserve import check_against_oracle, make_workload
from repro_torch.sortserve import EngineConfig, SortRequest, SortServeEngine
from repro_torch.sortserve.backends import ShardedColskipBackend
from repro_torch.sortserve.batcher import Tile


def _i32(t):
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def _rows(ds: str, b: int, n: int, seed: int) -> np.ndarray:
    return np.stack([make_dataset(ds, n, 32, seed=seed + r)
                     for r in range(b)]).astype(np.uint32)


def _stacked(x: np.ndarray, banks: int) -> np.ndarray:
    b, n = x.shape
    return np.ascontiguousarray(
        x.reshape(b, banks, n // banks).transpose(1, 0, 2)
        .reshape(-1, n // banks))


def _jax_hooks(banks: int):
    """The bank-stacked gates in jnp: OR over the banks, the bank sum and
    the exclusive bank-major prefix, every bank given the result."""
    def or_any(bits):
        return jnp.tile(bits.reshape(banks, -1, bits.shape[-1]).any(0),
                        (banks, 1))

    def drain_counts(m):
        per = m.reshape(banks, -1)
        return (jnp.tile(per.sum(0), (banks,)),
                (jnp.cumsum(per, 0) - per).reshape(-1))
    return or_any, drain_counts


# the plain mesh's per-bank state against the JAX machine with the same
# hooks: every dataset, D, carrier, fuse, k and an early exit, each value
# at least twice (a JAX machine compiles per case, so not the full product)
_HOOK_CASES = [
    ("uniform", 2, True, 2, 2, None), ("normal", 4, False, 1, 0, None),
    ("clustered", 8, True, 4, 2, 5), ("kruskal", 1, False, 2, 2, 1),
    ("mapreduce", 4, True, 1, 0, 16), ("uniform", 8, False, 4, 0, None),
    ("normal", 2, True, 4, 2, 7), ("mapreduce", 8, False, 2, 2, None),
    ("clustered", 4, True, 2, 0, None), ("kruskal", 2, True, 1, 2, 3),
]


@pytest.mark.parametrize("ds,banks,packed,fuse,k,stop", _HOOK_CASES)
def test_plain_mesh_state_equals_jax_machine_with_hooks(ds, banks, packed,
                                                        fuse, k, stop):
    x = _rows(ds, 2, 64, 7 * banks + k)
    s = 64 if stop is None else stop
    sh = _stacked(x, banks)
    or_any, drain_counts = _jax_hooks(banks)
    want = jax_machine(jnp.asarray(sh), 32, k, s, or_any=or_any,
                       drain_counts=drain_counts, packed=packed, fuse=fuse)
    t_or, t_drain = bank_hooks(banks)
    got = colskip_machine(torch.from_numpy(sh.astype(np.int64)), 32, k, s,
                          or_any=t_or, drain_counts=t_drain, packed=packed,
                          fuse=fuse)
    for name, g, v in zip(("sorted", "out_pos", "crs", "drains"), got, want):
        v = np.asarray(v)
        if name == "out_pos":                  # undrained positions: 0 both
            g = torch.where(got[0], g, 0)
            v = np.where(np.asarray(want[0]), v, 0)
        assert np.array_equal(g.numpy().astype(v.dtype), v), name


def _sweep():
    """Every dataset x D x carrier x fuse x k x stop_after value (and every
    D x fuse pair), in a sample of every 17th case of the full product of
    480: 29 cases."""
    full = list(itertools.product(sorted(DATASETS), (1, 2, 4, 8),
                                  (True, False), (1, 2, 4), (0, 2),
                                  (None, 9)))
    return full[::17]


@pytest.mark.parametrize("ds,banks,packed,fuse,k,stop", _sweep())
def test_plain_mesh_equals_local_machines(ds, banks, packed, fuse, k, stop):
    x = _rows(ds, 2, 64, 3 + banks)
    s = 64 if stop is None else stop
    got = sort_mesh_ref(torch.from_numpy(x), banks, 32, k, s, packed=packed,
                        fuse=fuse)
    local = sort_ref(torch.from_numpy(x), 32, k, s)
    for g, v in zip(got, local):
        assert torch.equal(_i32(g), _i32(v))
    # the wrapper takes the plain mesh for CPU tensors
    wrapped = ops.colskip_sort_mesh_batched(x, banks, 32, k, stop_after=stop,
                                            packed=packed, fuse=fuse,
                                            device="cpu")
    for g, v in zip(wrapped, got):
        assert torch.equal(_i32(g), _i32(v))


@pytest.mark.parametrize("ds,banks,fuse,k,stop", [
    ("mapreduce", 4, 2, 2, None), ("uniform", 8, 4, 0, 11),
    ("kruskal", 2, 1, 2, 3), ("clustered", 4, 4, 2, None),
    ("normal", 1, 2, 2, None),
])
def test_plain_mesh_equals_reference_kernel_and_multibank(ds, banks, fuse, k,
                                                          stop):
    x = _rows(ds, 2, 128, 40 + banks)
    s = 128 if stop is None else stop
    got = sort_mesh_ref(torch.from_numpy(x), banks, 32, k, s, fuse=fuse)
    want = ref_sort_batched(jnp.asarray(x), 32, k, stop_after=stop,
                            use_pallas=True, interpret=True)
    for g, v in zip(got, want):
        assert np.array_equal(_i32(g).numpy(),
                              np.asarray(v).view(np.int32)
                              if np.asarray(v).dtype == np.uint32
                              else np.asarray(v))
    if stop is None:                      # §V.C: any bank count, same cycles
        for r in range(2):
            mono = multibank_colskip_sort(x[r].astype(np.uint64), 32, k,
                                          banks=banks)
            assert int(got[3][r]) == mono.cycles
            assert int(got[2][r]) == mono.column_reads


@pytest.mark.parametrize("w,stop,fuse", [(32, 128, 1), (32, 7, 2),
                                         (16, 64, 4), (30, 9, 4),
                                         (32, 1, 8)])
def test_collective_rounds_equal_reference(w, stop, fuse):
    assert collective_rounds(w, stop, fuse) == ref_collective_rounds(w, stop,
                                                                     fuse)


GEO = dict(tile_rows=4, min_bucket=8, banks=4, bank_width=64, bank_rows=4,
           sim_width_cap=4096, cache_size=0, device="cpu")


def _copies(reqs):
    return [SortRequest(q.op, q.payload.copy(), k=q.k) for q in reqs]


def test_parity_body_in_process_on_4_bank_mesh():
    """``_PARITY_BODY`` of tests/test_bankmesh.py on the port's mesh."""
    def engines():
        local = SortServeEngine(EngineConfig(backends=("colskip",), **GEO))
        mesh = SortServeEngine(EngineConfig(backends=("colskip_mesh",),
                                            mesh=True, **GEO))
        return local, mesh

    local, mesh = engines()
    assert mesh.pool.n_devices == 4
    for dataset in ("uniform", "mapreduce"):
        v = make_dataset(dataset, 128, 32, seed=13).astype(np.uint32)
        mono = multibank_colskip_sort(v.astype(np.uint64), 32, 2, banks=4)
        rl = local.submit([SortRequest("sort", v.copy())])[0]
        rm = mesh.submit([SortRequest("sort", v.copy())])[0]
        assert rl.cycles == rm.cycles == mono.cycles, dataset
        assert rl.column_reads == rm.column_reads == mono.column_reads
        assert np.array_equal(rl.values, rm.values)

    local, mesh = engines()
    reqs = make_workload(24, min_len=8, max_len=128, seed=42,
                         ops=("sort", "argsort", "kmin"))
    resp_l = local.submit(_copies(reqs))
    resp_m = mesh.submit(_copies(reqs))
    for q, a, b in zip(reqs, resp_l, resp_m):
        assert a.cycles == b.cycles and a.column_reads == b.column_reads
        if a.values is not None:
            assert np.array_equal(a.values, b.values)
        if a.indices is not None:
            assert np.array_equal(a.indices, b.indices)
        assert check_against_oracle(q, b), (q.op, q.n)
    tl, tm = local.telemetry(), mesh.telemetry()
    assert tl["cycles_exact"] == tm["cycles_exact"]
    assert tl["column_reads"] == tm["column_reads"]
    assert tl["scheduler"] == tm["scheduler"]      # drains, waves, per-bank
    assert tm["per_backend"]["colskip_mesh"]["tiles"] > 0


def test_hosts_body_in_process_on_2_hosts_x_2_banks():
    """``_HOSTS_BODY`` of tests/test_bankmesh.py on the port's mesh: the
    hosts x banks topology, the fuse sweep and the double buffer."""
    mesh = make_bank_mesh(hosts=2, device="cpu")
    assert mesh.devices.shape == (2, 2)
    assert mesh.axis_names == ("hosts", "banks")

    local = SortServeEngine(EngineConfig(backends=("colskip",), **GEO))
    reqs = make_workload(16, min_len=8, max_len=128, seed=11,
                         ops=("sort", "argsort", "kmin"))
    resp_l = local.submit(_copies(reqs))

    per_fuse = {}
    for fuse in (1, 2, 4):
        eng = SortServeEngine(EngineConfig(
            backends=("colskip_mesh",), mesh=True, mesh_hosts=2, fuse=fuse,
            **GEO))
        resp_m = eng.submit(_copies(reqs))
        for q, a, b in zip(reqs, resp_l, resp_m):
            assert a.cycles == b.cycles, (fuse, q.op, a.cycles, b.cycles)
            assert a.column_reads == b.column_reads
            if a.values is not None:
                assert np.array_equal(a.values, b.values)
            if a.indices is not None:
                assert np.array_equal(a.indices, b.indices)
            assert check_against_oracle(q, b), (fuse, q.op, q.n)
        tm = eng.telemetry()
        assert tm["scheduler"] == local.telemetry()["scheduler"]
        per_fuse[fuse] = tm["collectives"]

    base = per_fuse[1]
    assert base["rounds"] == base["unfused_rounds"] > 0
    assert base["planes"] > 0 and base["round_cr"] == 1.0
    for fuse in (2, 4):
        c = per_fuse[fuse]
        assert c["planes"] == base["planes"], fuse
        assert c["unfused_rounds"] == base["unfused_rounds"], fuse
        assert c["rounds"] < base["rounds"], fuse
        assert c["round_cr"] > 1.0
    assert per_fuse[4]["rounds"] < per_fuse[2]["rounds"]
    assert per_fuse[2]["round_cr"] >= 1.5          # w=32 acceptance floor

    # deterministic double-buffer check: every tile needs the whole pool
    # and all arrive at vt 0, so admission is strictly serial FIFO — each
    # admit after the first sees exactly one successor to stage
    eng = SortServeEngine(EngineConfig(
        backends=("colskip_mesh",), mesh=True, mesh_hosts=2, fuse=2, **GEO))
    rng = np.random.default_rng(5)
    tiles = [Tile(op="sort",
                  data=rng.integers(0, 1 << 32, (4, 256), dtype=np.uint64)
                  .astype(np.uint32), k=None, entries=[], pad_rows=4)
             for _ in range(6)]
    eng.scheduler.feed(tiles, eng._execute, at=0.0)
    eng.scheduler.pump()
    c2 = eng.telemetry()["collectives"]
    assert c2["prefetch_staged"] == 4, c2
    assert c2["prefetch_hits"] == 4, c2


def test_mesh_pool_geometry_and_kmin_early_exit():
    pool = MeshBankPool(banks=4, bank_width=64, bank_rows=4, device="cpu")
    assert pool.shards_for(100) == 2
    assert pool.n_devices == 4
    assert pool.bank_labels() == [f"bank {i} @ cpu/bank{i}" for i in range(4)]
    wide = MeshBankPool(banks=6, bank_width=64, devices=2, device="cpu")
    assert wide.bank_labels()[5] == "bank 5 @ cpu/bank1"

    v = make_dataset("mapreduce", 64, 32, seed=3).astype(np.uint32)
    eng = SortServeEngine(EngineConfig(
        backends=("colskip_mesh",), mesh=True, tile_rows=1, bank_rows=1,
        banks=4, bank_width=64, sim_width_cap=4096, cache_size=0,
        device="cpu"))
    full = eng.submit([SortRequest("sort", v.copy())])[0]
    kmin = eng.submit([SortRequest("kmin", v.copy(), k=4)])[0]
    assert kmin.cycles < full.cycles          # k-early-exit drain
    assert check_against_oracle(SortRequest("kmin", v.copy(), k=4), kmin)


def test_fingerprint_shares_launchers_and_one_bank_fallback():
    a = ShardedColskipBackend(device="cpu")
    b = ShardedColskipBackend(mesh=make_bank_mesh(4, device="cpu"))
    assert a.mesh is not b.mesh
    assert topology_fingerprint(a.mesh) == topology_fingerprint(b.mesh)
    assert topology_fingerprint(make_bank_mesh(hosts=2, device="cpu")) != \
        topology_fingerprint(a.mesh)
    assert a.warm(4, 96, "sort", None) is True       # a build: a miss
    assert b.warm(4, 96, "sort", None) is False      # an equal mesh: a hit
    # a width that does not divide over the banks runs on one bank
    data = np.arange(4 * 30, dtype=np.uint32).reshape(4, 30)[:, ::-1].copy()
    res = b.run(Tile(op="sort", data=data, k=None, entries=[], pad_rows=4))
    assert res.meta["mesh_banks"] == 1 and res.meta["coll_rounds"] == 0
    assert np.array_equal(res.values, np.sort(data, -1))
    res = b.run(Tile(op="sort", data=data[:, :28].copy(), k=None, entries=[],
                     pad_rows=4))
    assert res.meta["mesh_banks"] == 4 and res.meta["coll_rounds"] > 0


def test_mesh_argument_checks():
    mesh = make_bank_mesh(device="cpu")
    x = np.zeros((2, 30), np.uint32)
    with pytest.raises(ValueError, match="divisible"):
        colskip_sort_mesh(x, mesh)
    with pytest.raises(ValueError, match="stop_after"):
        colskip_sort_mesh(np.zeros((2, 32), np.uint32), mesh, stop_after=0)
    with pytest.raises(ValueError, match="banks"):
        make_bank_mesh(9, device="cpu")
    with pytest.raises(ValueError, match="hosts"):
        make_bank_mesh(3, hosts=2, device="cpu")
    with pytest.raises(ValueError, match="fuse"):
        EngineConfig(mesh=True, fuse=9, device="cpu")
    with pytest.raises(ValueError, match="mesh_hosts"):
        EngineConfig(mesh_hosts=2, device="cpu")
    # a compile cache is a kernel-library directory, taken as given
    assert EngineConfig(compile_cache="/nonexistent",
                        device="cpu").compile_cache == "/nonexistent"
    # on the CPU any fuse in 1..8 runs the plain mesh
    got = colskip_sort_mesh(np.arange(32, dtype=np.uint32)[None, ::-1].copy(),
                            mesh, fuse=3)
    assert np.array_equal(got[0].numpy(), np.arange(32, dtype=np.uint32)[None])


def test_dense_carrier_mesh_engine_matches_local():
    reqs = make_workload(12, min_len=8, max_len=64, seed=9,
                         ops=("sort", "argsort", "kmin"))
    local = SortServeEngine(EngineConfig(backends=("colskip",), **GEO))
    mesh = SortServeEngine(EngineConfig(backends=("colskip_mesh",),
                                        mesh=True, fuse=4, packed=False,
                                        **GEO))
    for q, a, b in zip(reqs, local.submit(_copies(reqs)),
                       mesh.submit(_copies(reqs))):
        assert (a.cycles, a.column_reads) == (b.cycles, b.column_reads)
        assert check_against_oracle(q, b)
    assert mesh.backends[0].packed is False
    assert local.telemetry()["scheduler"] == mesh.telemetry()["scheduler"]
