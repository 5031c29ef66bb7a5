"""The port's serving engine vs the JAX reference's.

  * on the CPU the port reproduces ``tests/golden/continuous_telemetry.json``
    (the seed-21 flushed workload of test_continuous.py) byte for byte;
  * its flattened telemetry key set — and its OpenMetrics series names —
    equal the reference engine's on the same workload;
  * cost-policy priors and the engine config cross between the packages
    in both directions and give identical routing;
  * the radix backend's tile body (one launch of the radix kernel's top-k
    entry on the card, its plain version here) equals the reference's
    jitted tile body: values, indices and plane reads;
  * ``python -m repro_torch.launch.sortserve --smoke --device cpu`` passes.
"""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.launch.sortserve import make_workload
from repro.sortserve import CostPolicy as RefCostPolicy
from repro.sortserve import EngineConfig as RefEngineConfig
from repro.sortserve import SortServeEngine as RefEngine
from repro.sortserve import resolve_backends as ref_resolve
from repro.sortserve.backends import _radix_select as ref_radix_select
from repro.sortserve.batcher import Tile as RefTile
from repro_torch.launch.sortserve import check_against_oracle
from repro_torch.launch.sortserve import make_workload as port_workload
from repro_torch.sortserve import CostPolicy, EngineConfig, SortServeEngine
from repro_torch.sortserve import resolve_backends
from repro_torch.sortserve.backends import _radix_select
from repro_torch.sortserve.batcher import Tile
from repro_torch.sortserve.engine import config_from_reference

from _torch_golden import GOLDEN, GOLDEN_CFG, golden_payload, golden_text

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_port_engine_reproduces_golden_byte_for_byte():
    engine = SortServeEngine(EngineConfig(**GOLDEN_CFG, device="cpu"))
    live = golden_text(golden_payload(engine))
    assert live.strip() == GOLDEN.read_text().strip()


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        path = f"{prefix}{k}"
        out.add(path)
        if isinstance(v, dict):
            out |= _keys(v, path + ".")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            out |= _keys(v[0], path + "[].")
    return out


# seeded tiles of sortable words: distinct words, duplicates (ties at the
# threshold), a constant row and a constant tile; widths on the narrow
# instance (N <= 1,024) and the block instance; topk and kmin, k in
# {1, 17, N}
@pytest.mark.parametrize("b,n,data", [(8, 300, "uniform"), (3, 64, "dupes"),
                                      (8, 1500, "dupes"),
                                      (5, 1100, "constant")])
@pytest.mark.parametrize("kmin", [False, True])
def test_radix_tile_body_matches_reference(b, n, data, kmin):
    rng = np.random.default_rng(n + b)
    x = rng.integers(0, 1 << 32, (b, n), dtype=np.uint64).astype(np.uint32)
    if data == "dupes":
        x = (x % 7).astype(np.uint32) * np.uint32(0x1001)
    x[1] = np.uint32(0x80000000)               # a constant row
    if data == "constant":
        x[:] = np.uint32(12345)
    ref = jax.jit(ref_radix_select, static_argnums=(1, 2))
    for k in (1, 17, n):
        got = _radix_select(x, k, kmin, torch.device("cpu"))
        want = [np.asarray(a) for a in ref(x, k, kmin)]
        assert got[0].dtype == np.uint32 and got[1].dtype == np.int32
        assert got[2].dtype == np.int64
        assert all(g.flags.c_contiguous for g in got)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.astype(g.dtype))


# telemetry sections the port has and the reference has not: the stage
# spans' table (repro_torch.obs.tracer.Stages); and in each per_backend
# row, the machine backends' staging counts (repro_torch.sortserve.staging)
PORT_ONLY = {"stages"}
PORT_ONLY_BACKEND = {"staged_tiles", "staging_grows"}


def test_telemetry_keys_and_metric_names_match_reference():
    reqs = make_workload(24, min_len=8, max_len=128, seed=3)
    ref = RefEngine(RefEngineConfig(**GOLDEN_CFG))
    port = SortServeEngine(EngineConfig(**GOLDEN_CFG, device="cpu"))
    for _ in range(2):        # the second pass runs warm in both packages,
        ref.submit(reqs)      # so warm-only calibration cells line up
        port.submit(reqs)
    telem = port.telemetry()
    assert PORT_ONLY <= set(telem) and not PORT_ONLY & set(ref.telemetry())
    shared = {k: v for k, v in telem.items() if k not in PORT_ONLY}
    for row, ref_row in zip(shared["per_backend"].values(),
                            ref.telemetry()["per_backend"].values()):
        assert PORT_ONLY_BACKEND <= set(row)
        assert not PORT_ONLY_BACKEND & set(ref_row)
        for key in PORT_ONLY_BACKEND:
            del row[key]
    assert _keys(shared) == _keys(ref.telemetry())
    series = re.compile(r"^([a-z_]+)", re.M)
    assert set(series.findall(port.dump_metrics())) == \
        set(series.findall(ref.dump_metrics()))


def _priors():
    """Deterministic measured EMAs: jaxsort wins the sort race at 128, the
    simulator wins at 64, one class-private row."""
    return [
        {"backend": "colskip", "op": "sort", "n": 128, "k": None,
         "s_per_row": 4e-3, "samples": 20, "traffic_class": None},
        {"backend": "jaxsort", "op": "sort", "n": 128, "k": None,
         "s_per_row": 1e-4, "samples": 3, "traffic_class": None},
        {"backend": "colskip", "op": "argsort", "n": 64, "k": None,
         "s_per_row": 1e-5, "samples": 5, "traffic_class": None},
        {"backend": "jaxsort", "op": "argsort", "n": 64, "k": None,
         "s_per_row": 2e-4, "samples": 5, "traffic_class": None},
        {"backend": "jaxsort", "op": "kmin", "n": 512, "k": 4,
         "s_per_row": 9e-6, "samples": 2, "traffic_class": "batch"},
    ]


def _routes(policy, tile_cls, classes=(None, "batch")) -> list:
    out = []
    for op, n, k in [("sort", 128, None), ("sort", 64, None),
                     ("argsort", 64, None), ("argsort", 256, None),
                     ("kmin", 512, 4), ("kmin", 16, 8), ("topk", 32, 3),
                     ("sort", 4096, None)]:
        tile = tile_cls(op=op, data=np.zeros((4, n), np.uint32), k=k,
                        entries=[], pad_rows=4)
        for cls in classes:
            out.append(policy.choose(tile, traffic_class=cls).name)
    return out


def test_priors_cross_both_ways_with_identical_routing():
    names = ("colskip", "radix_topk", "jaxsort", "numpy")
    port = CostPolicy(resolve_backends(names, colskip={"device": "cpu"},
                                       radix_topk={"device": "cpu"},
                                       jaxsort={"device": "cpu"}),
                      sim_width_cap=256)
    ref = RefCostPolicy(ref_resolve(names), sim_width_cap=256)
    # reference -> port
    assert ref.load_priors(_priors()) == 5
    assert port.load_priors(ref.export_priors(include_classes=True)) == 5
    assert port.export_priors(include_classes=True) == \
        ref.export_priors(include_classes=True)
    assert _routes(port, Tile) == _routes(ref, RefTile)
    # port -> reference
    ref2 = RefCostPolicy(ref_resolve(names), sim_width_cap=256)
    assert ref2.load_priors(port.export_priors(include_classes=True)) == 5
    assert _routes(ref2, RefTile) == _routes(port, Tile)
    assert "jaxsort" in _routes(port, Tile)      # the priors moved routing


def test_config_crosses_from_reference():
    d = dataclasses.asdict(RefEngineConfig(**GOLDEN_CFG))
    cfg = config_from_reference(d, device="cpu")
    assert cfg == EngineConfig(**GOLDEN_CFG, device="cpu")
    live = golden_text(golden_payload(SortServeEngine(cfg)))
    assert live.strip() == GOLDEN.read_text().strip()
    # the mesh options and the compile cache (a kernel-library directory
    # in the port) cross as they are
    mesh = config_from_reference({**d, "mesh": True, "mesh_hosts": 2,
                                  "fuse": 2}, device="cpu")
    assert (mesh.mesh, mesh.mesh_hosts, mesh.fuse) == (True, 2, 2)
    assert config_from_reference({**d, "compile_cache": "/tmp/x"},
                                 device="cpu").compile_cache == "/tmp/x"
    with pytest.raises(ValueError, match="use_pallas"):
        config_from_reference({**d, "use_pallas": True}, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        config_from_reference({**d, "replicas": 2}, device="cpu")


def test_oracle_check_and_launcher_smoke_on_cpu():
    reqs = make_workload(12, min_len=8, max_len=64, seed=5)
    for q, p in zip(reqs, port_workload(12, min_len=8, max_len=64, seed=5)):
        assert (q.op, q.k, q.payload.tobytes()) == \
            (p.op, p.k, p.payload.tobytes())
    engine = SortServeEngine(EngineConfig(**GOLDEN_CFG, device="cpu"))
    assert all(check_against_oracle(q, r)
               for q, r in zip(reqs, engine.submit(reqs)))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sortserve", "--smoke",
         "--device", "cpu", "--requests", "40", "--max_len", "256",
         "--sim_width_cap", "256"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "SMOKE OK"
    assert "oracle mismatches: 0" in out.stdout
