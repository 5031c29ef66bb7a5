"""The machine backends' persistent staging (repro_torch.sortserve.staging)
on the CPU: the output slab's layout, growth, views and the copies in and
out; the backends' one staged path, which runs the plain machines on the
CPU's buffers there and counts no tile as staged.  On the card:
tests/test_torch_gpu.py."""

import numpy as np
import pytest
import torch

from repro_torch.launch.sortserve import (
    check_against_oracle,
    make_workload,
)
from repro_torch.sortserve import EngineConfig, SortServeEngine, backends
from repro_torch.sortserve.backends import (
    ColskipBackend,
    ShardedColskipBackend,
    solve_numpy,
)
from repro_torch.sortserve.batcher import Tile
from repro_torch.sortserve.staging import OUTPUTS, Staging, out_layout


@pytest.mark.parametrize("b,stop,mesh,want", [
    (8, 1024, False, {"values": (0, 8192), "order": (8192, 16384),
                      "column_reads": (16384, 16392),
                      "cycles": (16392, 16400)}),
    (8, 1024, True, {"values": (0, 8192), "order": (8192, 16384),
                     "column_reads": (16384, 16392),
                     "cycles": (16392, 16400), "rounds": (16400, 16408)}),
    (3, 17, False, {"values": (0, 51), "order": (51, 102),
                    "column_reads": (102, 105), "cycles": (105, 108)}),
    (1, 1, True, {"values": (0, 1), "order": (1, 2), "column_reads": (2, 3),
                  "cycles": (3, 4), "rounds": (4, 5)}),
])
def test_out_layout_word_offsets(b, stop, mesh, want):
    lay = out_layout(b, stop, mesh)
    assert list(lay) == list(OUTPUTS[:len(want)])
    assert {k: (s.start, s.stop) for k, s in lay.items()} == want


@pytest.mark.parametrize("b,stop", [(8, 1024), (3, 2048), (8, 16), (1, 64)])
@pytest.mark.parametrize("mesh", [False, True])
def test_output_views_tile_the_used_words_without_overlap(b, stop, mesh):
    st = Staging("cpu")
    out = st.output(b, stop, mesh)
    words = np.zeros(out.dev.numel(), np.int64)
    for name, t in zip(out.layout, out.outs):
        assert t.shape == ((b, stop) if name in ("values", "order") else (b,))
        first = (t.data_ptr() - out.dev.data_ptr()) // 4
        assert first == out.layout[name].start
        words[first:first + t.numel()] += 1
    assert (words == 1).all()               # every used word, once


def test_slabs_grow_only_for_a_larger_tile():
    st = Staging("cpu", slots=2)
    first = st.input(8, 1024)
    assert st.drain_grows() == 1 and st.input(8, 1024) is first
    st.output(8, 1024)
    assert st.drain_grows() == 1
    for b, n, stop in [(8, 64, 64), (3, 2048, 2048), (8, 1024, 16),
                       (8, 1024, 1024)]:
        st.input(b, n)
        st.output(b, stop)
    assert st.drain_grows() == 0            # each fits what is there
    st.input(8, 2048)                       # 16,384 words: past 8,192
    assert st.drain_grows() == 1
    st.input(8, 2048, slot=1)               # another slot, its own buffer
    assert st.drain_grows() == 1
    st.output(8, 2048)                      # 32,784 words: past 32,768
    assert st.drain_grows() == 1
    assert st.drain_grows() == 0
    assert st.input(8, 2048).x.data_ptr() != st.input(8, 2048, 1).x.data_ptr()
    # a grown buffer never shrinks: the small tile now lies in the new one
    small = st.input(8, 64)
    assert small.x.untyped_storage().nbytes() == 16384 * 4
    assert st.drain_grows() == 0


def test_put_and_take_copy_and_own_their_words():
    rng = np.random.default_rng(0)
    st = Staging("cpu")
    data = rng.integers(0, 1 << 32, (3, 40), dtype=np.uint64).astype(
        np.uint32)
    x = st.put(data, st.input(3, 40))
    assert np.array_equal(x.numpy().view(np.uint32), data)
    out = st.output(3, 40)
    for t in out.outs:
        t.fill_(7)
    words = st.take(out)
    assert (words == 7).all() and words.size == 2 * 3 * 40 + 2 * 3
    assert not np.shares_memory(words, out.host)
    got = backends.split(words, out)
    assert got["values"].dtype == np.uint32 and got["values"].shape == (3, 40)
    assert got["order"].dtype == np.int32
    assert got["cycles"].dtype == np.int64 and "rounds" not in got


def _tiles(rng, shapes):
    return [Tile(op=op, data=rng.integers(0, 1 << 32, (b, n), dtype=np.uint64)
                 .astype(np.uint32), k=k, entries=[], pad_rows=b)
            for op, b, n, k in shapes]


def _assert_reference(tile, res):
    out = tile.data.shape[1] if tile.k is None else tile.k
    for row in range(tile.data.shape[0]):
        v, i = solve_numpy(tile.op, tile.data[row], tile.k)
        assert np.array_equal(res.values[row], v[:out])
        assert np.array_equal(res.indices[row], i[:out])


@pytest.mark.parametrize("mesh", [False, True])
def test_staged_results_stay_their_own_after_later_tiles(monkeypatch, mesh):
    # the one staged path, on the CPU's buffers (the mesh staging each
    # successor ahead first): every earlier result must still equal the
    # reference after later tiles reused the slabs
    for name in ("kernel_rounds", "static_rounds"):
        monkeypatch.setattr(ShardedColskipBackend, name, 0)
    be = (ShardedColskipBackend(mesh=None, device="cpu") if mesh
          else ColskipBackend(device="cpu"))
    tiles = _tiles(np.random.default_rng(3), [
        ("sort", 4, 64, None), ("argsort", 4, 16, None),
        ("sort", 3, 128, None), ("kmin", 4, 64, 5), ("sort", 2, 6, None)])
    results = []
    for i, t in enumerate(tiles):
        if mesh and i + 1 < len(tiles):
            be.prefetch(tiles[i + 1])
        results.append(be.run(t))
    for t, res in zip(tiles, results):
        _assert_reference(t, res)
        # nothing crossed to a card: nothing counts as staged
        assert res.meta["staged"] is False
        assert res.meta["staging_grows"] == 0
        assert res.cycles.dtype == np.int64
    if mesh:                # 4 banks: the (2, 6) tile falls back to one
        assert [r.meta["mesh_banks"] for r in results] == [4, 4, 4, 4, 1]
        assert [r.meta["prefetch_hit"] for r in results] == [
            False, True, True, True, False]
        # rounds are the kernel's, not a property of the plain mesh
        assert ShardedColskipBackend.kernel_rounds == 0
        assert ShardedColskipBackend.static_rounds == 0


def test_warm_growing_a_slot_keeps_a_tile_staged_ahead():
    # a tile staged ahead into a slot, then warm() of a wider signature
    # grows that slot: the staged tile runs on the words it was given
    be = ShardedColskipBackend(mesh=None, device="cpu")
    small, wide = _tiles(np.random.default_rng(11), [
        ("argsort", 2, 64, None), ("sort", 8, 2048, None)])
    be.warm(2, 64, "argsort", None)
    assert be.prefetch(small)
    slot = be._staged[id(small)][1]
    before = be._staging._in[slot]
    be.warm(8, 2048, "sort", None)
    assert be._staging._in[slot] is not before     # the slot did grow
    res = be.run(small)
    assert res.meta["prefetch_hit"] is True
    _assert_reference(small, res)
    _assert_reference(wide, be.run(wide))


@pytest.mark.parametrize("backend", ["colskip", "colskip_mesh"])
def test_plain_path_does_not_stage_and_equals_the_reference(backend):
    eng = SortServeEngine(EngineConfig(
        backends=(backend, "radix_topk"), tile_rows=4, min_bucket=8,
        banks=4, bank_width=64, bank_rows=4, sim_width_cap=256,
        cache_size=0, mesh=backend == "colskip_mesh", device="cpu"))
    reqs = make_workload(12, min_len=8, max_len=64, seed=4)
    got = eng.submit(reqs)
    assert all(check_against_oracle(q, r) for q, r in zip(reqs, got))
    for row in eng.telemetry()["per_backend"].values():
        assert row["staged_tiles"] == 0 and row["staging_grows"] == 0
    assert eng.telemetry()["per_backend"][backend]["tiles"] > 0


@pytest.mark.parametrize("rounds", [False, True])
def test_launch_refuses_outputs_the_kernel_would_overrun(rounds):
    # the kernel writes through the pointers of preallocated outputs, so
    # the launch checks them first; a staging's views pass
    from repro_torch.kernels.colskip import ops
    cpu = torch.device("cpu")
    view = Staging(cpu).output(3, 5, mesh=rounds)
    ops._check_outputs(view.outs, 3, 5, cpu, rounds)
    bad = [view.outs[:-1], view.outs + view.outs[-1:],
           (torch.empty((3, 6), dtype=torch.int32),) + view.outs[1:],
           (view.outs[0].to(torch.int64),) + view.outs[1:],
           (view.outs[0].t(),) + view.outs[1:]]
    for out in bad:
        with pytest.raises(ValueError, match="out:"):
            ops._check_outputs(out, 3, 5, cpu, rounds)
