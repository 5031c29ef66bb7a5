"""The port's dense colskip machine vs the JAX reference, exactly.

  * the plain dense machine (``packed=False``) equals the reference's
    dense Pallas kernel in interpret mode and the port's packed machine on
    all four outputs, over state depths k in {0, 1, 2, 4}, early exits
    ``stop_after`` in {1, 7, N} and widths that are not multiples of 32
    (the cases of test_packed_machine.py);
  * ``colskip_sort_torch`` equals ``colskip_sort_jax`` on both carriers;
  * the engine with ``packed=False`` on the CPU reproduces the golden
    telemetry byte for byte, and the CPU ``--dense`` launcher smoke passes.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import colskip_sort_jax
from repro.core.datasets import DATASETS, make_dataset
from repro.kernels.colskip import colskip_sort_batched as ref_sort_batched
from repro_torch.core.jaxsort import colskip_sort_torch
from repro_torch.kernels.colskip import colskip_sort_batched
from repro_torch.sortserve import EngineConfig, SortServeEngine

from _torch_golden import GOLDEN, GOLDEN_CFG, golden_payload, golden_text

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("values", "order", "column_reads", "cycles")


def _rows(kind, b, n, w, seed):
    return np.stack([make_dataset(kind, n, w, seed=seed + r)
                     for r in range(b)]).astype(np.uint32)


def _assert_same(got, want, what=""):
    for field, g, w in zip(FIELDS, got, want):
        w = np.asarray(w)
        assert g.dtype == getattr(torch, str(w.dtype)), (field, what)
        assert np.array_equal(g.numpy(), w), (field, what)


CASES = [(k, stop_mode) for k in (0, 1, 2, 4) for stop_mode in ("1", "7", "N")]


@pytest.mark.parametrize("k,stop_mode", CASES)
def test_dense_machine_matches_dense_pallas_and_packed_machine(k, stop_mode):
    i = CASES.index((k, stop_mode))
    n = (17, 24, 33, 40, 64)[i % 5]           # 17, 33: not multiples of 32
    kind = sorted(DATASETS)[i % len(DATASETS)]
    x = _rows(kind, 3, n, 16, 100 + i)
    stop = {"1": 1, "7": min(7, n), "N": None}[stop_mode]
    want = ref_sort_batched(jnp.asarray(x), 16, k, use_pallas=True,
                            interpret=True, stop_after=stop, packed=False)
    dense = colskip_sort_batched(x, 16, k, stop_after=stop, packed=False,
                                 device="cpu")
    packed = colskip_sort_batched(x, 16, k, stop_after=stop, packed=True,
                                  device="cpu")
    _assert_same(dense, want, "dense vs pallas")
    for d, p in zip(dense, packed):
        assert torch.equal(d, p)


@pytest.mark.parametrize("dataset", ["uniform", "mapreduce", "clustered"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_colskip_sort_torch_matches_colskip_sort_jax(dataset, k):
    v = make_dataset(dataset, 128, 32, seed=5).astype(np.uint32)
    for packed in (True, False):
        want = colskip_sort_jax(jnp.asarray(v), 32, k, None, packed)
        got = colskip_sort_torch(v, 32, k, packed=packed, device="cpu")
        _assert_same(got, want, f"packed={packed}")
        assert got[2].dim() == 0 and got[3].dim() == 0


def test_colskip_sort_torch_early_exit_and_one_row_only():
    v = make_dataset("kruskal", 64, 32, seed=2).astype(np.uint32)
    want = colskip_sort_jax(jnp.asarray(v), 32, 2, 9, False)
    _assert_same(colskip_sort_torch(v, 32, 2, 9, packed=False, device="cpu"),
                 want)
    with pytest.raises(ValueError, match="one row"):
        colskip_sort_torch(v.reshape(2, 32), device="cpu")


def test_dense_engine_reproduces_golden_byte_for_byte():
    engine = SortServeEngine(EngineConfig(**GOLDEN_CFG, packed=False,
                                          device="cpu"))
    live = golden_text(golden_payload(engine))
    assert live.strip() == GOLDEN.read_text().strip()


def test_dense_launcher_smoke_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sortserve", "--smoke",
         "--dense", "--device", "cpu", "--requests", "40", "--max_len",
         "256", "--sim_width_cap", "256"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "SMOKE OK"
    assert "oracle mismatches: 0" in out.stdout


def test_single_row_entry_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = np.arange(16, dtype=np.uint32)
    for packed in (True, False):
        with pytest.raises(RuntimeError, match="cuda"):
            colskip_sort_torch(v, packed=packed)
    with pytest.raises(RuntimeError, match="cuda"):
        EngineConfig(packed=False)
