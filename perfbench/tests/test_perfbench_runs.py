"""Whole runs on the CPU at a small size (the look for a card skipped):
a sound run is correct; the control and each fault the cells can have
are not."""

import numpy as np
import pytest

from _small import small_root
from perfbench import harness

SEED = 2**31 + 99
SECONDS = 1.5
BACKLOG = ["csk.uniform1024.backlog", "csk.mapreduce1024.backlog",
           "mesh4.uniform1024.backlog"]
MACHINES = ("colskip", "colskip_mesh")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, patch=None, trace=False):
    return harness.run_cell(root, cell, SEED, SECONDS, trace, device="cpu",
                            patch=patch, log=lambda msg: None)


def wrap_machines(engine, alter):
    """Route every machine tile through ``alter(tile, result)``."""
    for be in engine.backends:
        if be.name in MACHINES:
            inner = be.run
            be.run = lambda tile, inner=inner: alter(tile, inner(tile))


@pytest.mark.parametrize("cell", BACKLOG + ["csk.mixed.poisson"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(root, cell, trace):
    result = run(root, cell, trace=trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    assert result["metrics"]


@pytest.mark.parametrize("cell", BACKLOG + ["csk.mixed.poisson"])
def test_control_is_not_correct(root, cell):
    """The program's own control (for the sorter: the reference machine at
    k = 1 in place of k = 2), as ``control.py`` puts it in place."""
    manifest = harness.load_manifest(root)
    name = harness.find_cell(manifest, cell)["config"]
    config = harness.load_config(root, manifest, name)
    program = harness.load_program(root, manifest, name)
    assert config["state_k"] == 2
    result = run(root, cell, patch=lambda e: program.control(e, config))
    assert not result["correct"]
    assert result["checks"]["reads"]["value"] > 0
    assert result["checks"]["values"]["value"] == 0


def unchanged(tile, result):
    """A step that returns its state unchanged: the rows as they came."""
    b, n = tile.data.shape
    out = result.values.shape[1]
    result.values = tile.data[:, :out].copy()
    result.indices = np.tile(np.arange(out, dtype=np.int32), (b, 1))
    return result


def altered(tile, result):
    """An answer altered where it is produced: one key of one row."""
    result.values = result.values.copy()
    result.values[0, -1] ^= np.uint32(1)
    result.column_reads = result.column_reads.copy()
    result.column_reads[0] += 1
    return result


@pytest.mark.parametrize("cell", BACKLOG + ["csk.mixed.poisson"])
@pytest.mark.parametrize("fault", [unchanged, altered])
def test_faults_in_the_machine_are_caught(root, cell, fault):
    result = run(root, cell, patch=lambda e: wrap_machines(e, fault))
    assert not result["correct"]


@pytest.mark.parametrize("cell", BACKLOG)
def test_half_the_batch_left_out_is_caught(root, cell):
    def patch(engine):
        scatter = engine._scatter

        def half(tile, result, lat_fn):
            keep = len(tile.entries) - len(tile.entries) // 2
            tile.entries = tile.entries[:keep]
            return scatter(tile, result, lat_fn)
        engine._scatter = half
    result = run(root, cell, patch=patch)
    assert not result["correct"]
    assert result["failed"] > 0


def test_exchange_between_banks_left_out_is_caught(root):
    """The mesh's cross-bank judgement left out: each bank sorts its own
    columns, and the banks' outputs are laid side by side."""
    from repro_torch.sortserve.backends import TileResult

    def patch(engine):
        be = next(b for b in engine.backends if b.name == "colskip_mesh")
        banks = be.n_devices
        local = be.run

        def run_banks(tile):
            full = local(tile)
            b, n = tile.data.shape
            part = n // banks
            vals = np.empty_like(full.values)
            idx = np.empty_like(full.indices)
            for k in range(banks):
                cols = tile.data[:, k * part:(k + 1) * part]
                order = np.argsort(cols, axis=1, kind="stable")
                vals[:, k * part:(k + 1) * part] = np.take_along_axis(
                    cols, order, 1)
                idx[:, k * part:(k + 1) * part] = order + k * part
            return TileResult(vals, idx, full.column_reads, full.cycles,
                              full.backend, meta=full.meta)
        be.run = run_banks
    result = run(root, "mesh4.uniform1024.backlog", patch=patch)
    assert not result["correct"]
    assert result["checks"]["values"]["value"] > 0
