"""The PyTorch port stands alone: no jax, no ``repro``, no silent CPU.

  * ``repro_torch`` and every submodule import in a process where ``jax``
    and ``repro`` cannot be imported;
  * no file of the port (nor ``chip_smoke.py``) imports either;
  * entry points default to ``cuda`` and raise when no card exists;
  * ``chip_smoke.py`` exits nonzero, printing no result, without a card
    and when it stands alone in a directory.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
IMPORT_RE = re.compile(r"^\s*(?:from|import)\s+(jax|repro)(?:\.|\s|$)", re.M)


def test_port_imports_without_jax_or_reference():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import importlib, pkgutil
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
for name in ("repro_torch.dist", "repro_torch.dist.bankmesh",
             "repro_torch.sortserve.fleet",
             "repro_torch.benchmarks.streaming_bench",
             "repro_torch.benchmarks.distserve_bench",
             "repro_torch.configs", "repro_torch.configs.gemma3_4b",
             "repro_torch.configs.granite_moe_3b_a800m",
             "repro_torch.models.blocks", "repro_torch.models.moe",
             "repro_torch.models.transformer", "repro_torch.models.api",
             "repro_torch.models.convert", "repro_torch.models.rwkv6",
             "repro_torch.models.hymba", "repro_torch.models.whisper",
             "repro_torch.serve.sampler",
             "repro_torch.serve.engine", "repro_torch.launch.serve",
             "repro_torch.data", "repro_torch.data.pipeline",
             "repro_torch.train", "repro_torch.train.optimizer",
             "repro_torch.train.loop", "repro_torch.ckpt",
             "repro_torch.ckpt.manager", "repro_torch.launch.train",
             "repro_torch.dist._comm", "repro_torch.dist.compress",
             "repro_torch.dist.sharding", "repro_torch.dist.pipeline",
             "repro_torch.core.distsort", "repro_torch.launch.mesh",
             "repro_torch.benchmarks.hw_bench",
             "repro_torch.benchmarks.hw_tune",
             "repro_torch.launch.analytic", "repro_torch.launch.roofline",
             "repro_torch.launch.dryrun",
             "repro_torch.launch.calibration_report",
             "repro_torch.launch.slo_report"):
    assert name in names, name
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_reference(path):
    assert IMPORT_RE.findall(path.read_text()) == []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.kernels.colskip import colskip_sort_batched
    from repro_torch.kernels.radix_topk import (
        radix_topk,
        radix_topk_threshold,
        threshold_sortable,
    )
    from repro_torch.dist.bankmesh import make_bank_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.kernels.colskip.ops import colskip_sort_mesh_batched
    from repro_torch.configs import get_config
    from repro_torch import train
    from repro_torch.launch import serve, sortserve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import api
    from repro_torch.sortserve import EngineConfig
    from repro_torch.benchmarks import hw_bench
    import runpy
    examples = {name: runpy.run_path(
        str(ROOT / "examples" / "torch" / f"{name}.py"))["main"]
        for name in ("sort_service", "trace_requests", "fleet_view")}

    x = np.arange(64, dtype=np.uint32).reshape(2, 32)
    xf = np.linspace(-1, 1, 64, dtype=np.float32).reshape(2, 32)
    calls = [lambda: colskip_sort_batched(x),
             lambda: radix_topk(xf, 3),
             lambda: radix_topk_threshold(xf, 3),
             lambda: threshold_sortable(x, 3),
             lambda: EngineConfig(),
             lambda: sortserve.main(["--requests", "4"]),
             lambda: sortserve.main(["--requests", "4", "--mesh"]),
             lambda: sortserve.main(["--requests", "4", "--replicas", "2"]),
             lambda: make_bank_mesh(),
             lambda: make_host_mesh(2, 2),
             lambda: colskip_sort_mesh_batched(x, 2),
             lambda: api.init(get_config("gemma3-4b", smoke=True)),
             lambda: api.init_cache(get_config("gemma3-4b", smoke=True), 1,
                                    4),
             lambda: serve.main(["--smoke"]),
             lambda: train.init_state(get_config("gemma3-4b", smoke=True)),
             lambda: launch_train.main(["--smoke", "--steps", "1"]),
             lambda: hw_bench.worker_fused((1,), 1),
             lambda: hw_bench.worker_persist("unused", 1),
             *[lambda m=m: m([]) for m in examples.values()]]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # only an explicit cpu runs the plain versions
    vals, order, _, _ = colskip_sort_batched(x, device="cpu")
    assert np.array_equal(vals.numpy(), x)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, cwd=script.parent,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
