"""The sort-serving hardware path of the port against the reference's.

  * the persistent kernel-library cache (``kernels/_build.py`` under
    ``ExecutorCache.enable_persistent``): a cold lookup builds (a miss), a
    fresh process on the same directory opens the library (a hit), a
    library already open is neither; ``nvcc`` and ``ctypes.CDLL`` are
    stubbed, since this machine has neither a toolkit nor a card;
  * ``EngineConfig(compile_cache=...)`` and ``config_from_reference``;
  * ``launch/sortserve.py``'s ``--hw-profile``: the priors and calibration
    rows land exactly as in the reference's engine, XLA flags are refused
    by name, and a profile from the port's ``hw_tune`` is accepted;
  * ``hw_bench``'s fused worker on the CPU (the plain mesh) at fuse 1, 2
    and 4: digests, cycles and column reads equal across fuse values and
    equal to the reference's local ``colskip`` engine on the same 12
    requests (the reference's own mesh path fails under jax 0.9.0).  The
    worker runs at N = 32 rather than the bench's 1024: the plain mesh
    takes ~8 s a (1, 1024) tile on the CPU.
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.sortserve import EngineConfig as RefEngineConfig
from repro.sortserve import SortRequest as RefSortRequest
from repro.sortserve import SortServeEngine as RefEngine
from repro_torch.benchmarks import hw_bench, hw_tune
from repro_torch.kernels import _build
from repro_torch.launch import sortserve as launcher
from repro_torch.sortserve import EngineConfig, SortServeEngine
from repro_torch.sortserve.backends import EXECUTOR_CACHE, ExecutorCache
from repro_torch.sortserve.engine import config_from_reference

N_CPU = 32


@pytest.fixture
def build_state(monkeypatch):
    """The build module's process state, restored after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(_build, "_listener", None)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_built_here", set())
    for name in ("persistent_dir", "persistent_hits", "persistent_misses"):
        monkeypatch.setattr(EXECUTOR_CACHE, name, getattr(EXECUTOR_CACHE,
                                                          name))


def test_persistent_hits_and_misses_across_processes(tmp_path, monkeypatch,
                                                     build_state):
    src = tmp_path / "csrc" / "toy.cu"
    src.parent.mkdir()
    src.write_text("// toy\n")
    nvcc = tmp_path / "nvcc"                   # writes -o and a report
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
                    "  shift\ndone\necho \"ptxas info: 0 bytes spill stores\"\n"
                    "echo call >> \"$(dirname \"$0\")/calls\"\n")
    nvcc.chmod(0o755)
    opened = []
    monkeypatch.setattr(_build, "sources", lambda: {"toy": src})
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: opened.append(path) or object())
    cache = tmp_path / "cache"

    # no directory set: lookups count nothing
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "default")
    plain = ExecutorCache()
    _build.load("toy")
    assert plain.persistent_counters() == (0, 0)
    monkeypatch.setattr(_build, "_libs", {})

    # the cold process: nvcc builds into the cache directory (a miss)
    cold = ExecutorCache()
    assert cold.enable_persistent(str(cache))
    assert _build.BUILD_DIR == cache and cold.persistent_dir == str(cache)
    _build.load("toy")
    _build.load("toy")                         # open in the process: neither
    assert cold.persistent_counters() == (0, 1)
    assert (tmp_path / "calls").read_text().count("call") == 2
    lib = _build._lib_path(src)
    assert lib.parent == cache and lib.exists()
    assert lib.with_suffix(".log").exists()

    # a fresh process on the same directory: opened from disk (a hit)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_built_here", set())
    warm = ExecutorCache()
    warm.enable_persistent(str(cache))
    _build.load("toy")
    assert warm.persistent_counters() == (1, 0)
    assert (tmp_path / "calls").read_text().count("call") == 2
    assert opened[-1] == str(lib)

    # an edited source is stale: its hash names another library (a miss)
    monkeypatch.setattr(_build, "_libs", {})
    src.write_text("// toy, edited\n")
    _build.load("toy")
    assert warm.persistent_counters() == (1, 1)
    assert _build._lib_path(src) != lib

    # back to the default directory, with no listener
    assert _build.set_build_dir() == _build.DEFAULT_BUILD_DIR
    assert _build._listener is None


def test_engine_config_takes_a_compile_cache(tmp_path, build_state):
    cfg = EngineConfig(compile_cache=str(tmp_path / "cc"), device="cpu",
                       backends=("numpy",))
    eng = SortServeEngine(cfg)
    assert EXECUTOR_CACHE.persistent_dir == str(tmp_path / "cc")
    assert _build.BUILD_DIR == tmp_path / "cc"
    ec = eng.telemetry()["executor_cache"]
    # the CPU opens no kernel library: nothing to hit or miss
    assert (ec["persistent_hits"], ec["persistent_misses"]) == (0, 0)
    d = dataclasses.asdict(RefEngineConfig(compile_cache=str(tmp_path / "cc"),
                                           backends=("numpy",)))
    crossed = config_from_reference(d, device="cpu")
    assert crossed.compile_cache == str(tmp_path / "cc")
    assert crossed == cfg


@pytest.fixture(scope="module")
def fused_doc():
    return hw_bench.worker_fused((1, 2, 4), 12, "cpu", n=N_CPU)


def _ref_local_digest():
    rng = np.random.default_rng(7)
    reqs = [RefSortRequest("sort", rng.integers(0, 1 << 32, N_CPU,
                                                dtype=np.uint64)
                           .astype(np.uint32)) for _ in range(12)]
    eng = RefEngine(RefEngineConfig(
        backends=("colskip",), tile_rows=1, banks=hw_bench.BANKS,
        bank_width=N_CPU // hw_bench.BANKS, bank_rows=8, sim_width_cap=4096,
        cache_size=0))
    resps = eng.submit(reqs)
    telem = eng.telemetry()
    return (hw_bench.digest(resps), telem["cycles_exact"],
            telem["column_reads"])


def test_fused_worker_matches_the_reference_local_engine(fused_doc):
    per = fused_doc["per_fuse"]
    assert sorted(per) == ["1", "2", "4"]
    want = _ref_local_digest()
    for fuse, pf in per.items():
        assert (pf["digest"], pf["cycles_exact"], pf["column_reads"]) \
            == want, fuse
        assert pf["tiles"] == 12 and pf["mesh_launches"] == 0   # plain mesh
        assert pf["collectives"]["planes"] == per["1"]["collectives"]["planes"]
    assert per["1"]["collectives"]["round_cr"] == 1.0
    assert per["2"]["collectives"]["round_cr"] >= 1.5
    assert per["4"]["collectives"]["round_cr"] > \
        per["2"]["collectives"]["round_cr"]
    rows = []
    assert hw_bench.fused_rows(lambda *r: rows.append(r), fused_doc)
    assert [r[0] for r in rows] == ["hw/fused_rounds_f1", "hw/fused_rounds_f2",
                                    "hw/fused_rounds_f4"]
    assert all(r[2].endswith("PASS") and "parity=exact" in r[2]
               for r in rows)
    # the persist pair has no library to load on the CPU: SKIP, not MISS
    rows.clear()
    assert hw_bench._persist_pair(lambda *r: rows.append(r), "cpu", 1)
    assert [r[2] for r in rows] == ["SKIP no kernel library on cpu"] * 2


def test_hw_profile_lands_as_in_the_reference(fused_doc, tmp_path):
    prof = hw_tune.profile_from(fused_doc, str(tmp_path / "cc"))
    assert prof["xla_flags"] == [] and prof["platform"] == "cpu"
    assert set(prof) == {"device_kind", "platform", "xla_flags",
                         "compile_cache", "priors", "calibration", "sweep"}
    assert prof["priors"] and prof["calibration"]
    path = tmp_path / "prof.json"
    path.write_text(json.dumps(prof))
    got = launcher.apply_hw_profile(str(path))
    port = SortServeEngine(EngineConfig(device="cpu"))
    ref = RefEngine(RefEngineConfig())
    assert launcher.seed_from_profile(port, got) == (
        ref.policy.load_priors(got["priors"]),
        ref._calib.seed_rows(got["calibration"]))
    assert port.policy.export_priors() == ref.policy.export_priors() \
        == prof["priors"]
    assert port._calib.profile_rows() == ref._calib.profile_rows()
    assert port.telemetry()["calibration"] == ref.telemetry()["calibration"]


def test_hw_profile_with_xla_flags_is_refused_by_name(tmp_path, capsys):
    flags = ["--xla_force_host_platform_device_count=4",
             "--xla_cpu_enable_fast_math=true"]
    path = tmp_path / "cpu_profile.json"
    path.write_text(json.dumps({"device_kind": "cpu", "platform": "cpu",
                                "xla_flags": flags, "compile_cache": None,
                                "priors": [], "calibration": [],
                                "sweep": []}))
    with pytest.raises(ValueError) as err:
        launcher.apply_hw_profile(str(path))
    assert all(flag in str(err.value) for flag in flags)
    with pytest.raises(SystemExit) as ex:
        launcher.main(["--smoke", "--device", "cpu", "--hw-profile",
                       str(path)])
    assert ex.value.code == 2
    err = capsys.readouterr().err
    assert all(flag in err for flag in flags)


def test_launcher_accepts_a_hw_tune_profile(fused_doc, tmp_path, capsys,
                                            build_state):
    prof = hw_tune.profile_from(fused_doc, str(tmp_path / "cc"))
    path = tmp_path / "prof.json"
    path.write_text(json.dumps(prof))
    rc = launcher.main(["--smoke", "--device", "cpu", "--requests", "8",
                        "--min_len", "16", "--max_len", "64",
                        "--sim_width_cap", "64", "--hw-profile", str(path)])
    out = capsys.readouterr().out
    assert rc == 0 and "SMOKE OK" in out
    assert (f"hw profile: {path} (device_kind=cpu, 0 xla flags, "
            f"{len(prof['priors'])} routing priors, "
            f"{len(prof['calibration'])} calibration rows)") in out
    # the profile's compile cache was taken: no --compile-cache given
    assert f"persistent cache: 0 hits / 0 misses -> {tmp_path / 'cc'}" in out
