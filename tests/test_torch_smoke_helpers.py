"""The CPU-side helpers of ``chip_smoke.py`` that gate and price a chip run.

  * ``register_path_spills`` reads the spill bytes of the colskip
    kernels' register instances (packed: WPL 1 and 2; dense: C = 4 .. 64
    elements a thread) from an ``-Xptxas -v`` report and ignores every
    other kernel and instance, so a spill there fails the run;
    ``mesh_spills`` names the mesh kernel instances that spill (printed,
    not a gate);
  * ``_searches`` counts the min searches a full sort of each row makes
    (its distinct values), the factor of the restated colskip bound;
  * the build keeps each library's ``-Xptxas -v`` report beside it, so a
    run that finds the library built still reads the spills;
  * ``_radix_recorder`` records each router and sampler ``radix_topk``
    call with its kernel launches by entry (the threshold, the fused
    top-k), and ``_plain_threshold`` routes both entries through their
    plain versions, so phases 8 to 10 replay the kernel against them.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _entry(name: str, stores: int, loads: int) -> str:
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads\n"
            "ptxas info    : Used 120 registers, used 0 barriers\n")


@pytest.mark.parametrize("wpl,spilled", [(1, False), (2, True), (4, None)])
def test_register_path_spills_reads_only_the_register_instances(
        smoke, wpl, spilled):
    name = (f"_ZN12_GLOBAL__N_119colskip_sort_kernelILi{wpl}EEEv"
            "PKjPjPiS4_S4_iiii")
    log = (_entry("_ZN12_GLOBAL__N_121bitonic_net_kernelILi8EEEvPKjPjiiii",
                  8, 8)
           + _entry(name, 12 if spilled else 0, 8 if spilled else 0))
    got = smoke.register_path_spills(log)
    if spilled is None:                        # the shared path: not read
        assert got == {}
    else:
        assert got == {name: (12, 8) if spilled else (0, 0)}


@pytest.mark.parametrize("c,reg_table,spilled", [
    (64, 1, False), (4, 0, True), (32, 1, True), (0, 0, None)])
def test_register_path_spills_reads_the_dense_register_instances(
        smoke, c, reg_table, spilled):
    name = (f"_ZN12_GLOBAL__N_120colskip_dense_kernelILi{c}ELb{reg_table}"
            "ELi1EEEvPKjPjPiS4_S4_iiii")
    got = smoke.register_path_spills(_entry(name, 4 if spilled else 0,
                                            4 if spilled else 0))
    if spilled is None:                        # the rolled instance
        assert got == {}
    else:
        assert got == {name: (4, 4) if spilled else (0, 0)}


def test_mesh_spills_name_each_spilling_mesh_instance(smoke):
    packed = ("_ZN48_GLOBAL__N__98f01702_15_colskip_mesh_cu_2fc1fb6219"
              "colskip_mesh_kernelILi32ELi8EEEvPKjPjPiS4_S4_S4_iiiii")
    dense = ("_ZN48_GLOBAL__N__98f01702_15_colskip_mesh_cu_2fc1fb6225"
             "colskip_mesh_dense_kernelILi16ELb1ELi4ELi3EEEvPKjPjPiS4_S4_"
             "S4_iiiii")
    quiet = packed.replace("ILi32ELi8E", "ILi1ELi8E")
    got = smoke.mesh_spills(_entry(packed, 20, 24) + _entry(dense, 4, 4)
                            + _entry(quiet, 0, 0))
    assert sorted(got) == ["colskip_mesh_dense_kernel<Li16ELb1ELi4ELi3E>",
                           "colskip_mesh_kernel<Li32ELi8E>"]
    assert "20 bytes spill stores" in got["colskip_mesh_kernel<Li32ELi8E>"]


def test_searches_count_distinct_values_per_row(smoke):
    x = torch.from_numpy(np.array([[5, 5, 1, 0xFFFFFFFF],
                                   [2, 2, 2, 2]], dtype=np.uint32))
    assert smoke._searches(x) == [3, 1]


def test_build_keeps_the_ptxas_report_beside_the_library(tmp_path,
                                                         monkeypatch):
    from repro_torch.kernels import _build
    src = tmp_path / "csrc" / "toy.cu"
    src.parent.mkdir()
    src.write_text("// toy\n")
    nvcc = tmp_path / "nvcc"                   # writes -o and a report
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
                    "  shift\ndone\necho \"ptxas info: 0 bytes spill stores\"\n"
                    "echo call >> \"$(dirname \"$0\")/calls\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "sources", lambda: {"toy": src})
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    first = _build.build_all()
    again = _build.build_all()                 # built: the kept report
    assert first == again == {"toy": "ptxas info: 0 bytes spill stores\n"}
    assert (tmp_path / "calls").read_text().count("call") == 1
    lib = _build._lib_path(src)
    lib.with_suffix(".log").unlink()           # a library with no report
    assert _build.build_all() == first
    assert (tmp_path / "calls").read_text().count("call") == 2


def test_build_compiles_a_parted_library_side_by_side(tmp_path,
                                                      monkeypatch):
    # a library of PARTS builds as one object a part (its -D<NAME>_PART),
    # then one link of them; the report holds every part's
    from repro_torch.kernels import _build
    src = tmp_path / "csrc" / "toy.cu"
    src.parent.mkdir()
    src.write_text("// toy\n")
    nvcc = tmp_path / "nvcc"                   # writes -o, logs its args
    nvcc.write_text("#!/bin/sh\necho \"$@\" >> \"$(dirname \"$0\")/calls\"\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then echo lib > \"$2\"; fi\n"
                    "  shift\ndone\necho \"ptxas info: part\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "sources", lambda: {"toy": src})
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "PARTS", {"toy": 3})
    log = _build.build_all()["toy"]
    calls = (tmp_path / "calls").read_text().splitlines()
    assert len(calls) == 4 and log.count("ptxas info: part") == 4
    # the parts run side by side, so their lines come in any order
    for p in range(3):
        call, = [c for c in calls[:3] if f"-DTOY_PART={p} " in c]
        assert f"-DTOY_PARTS=3 -DTOY_PART={p}" in call and " -c " in call
        assert "-shared" not in call
    link = calls[3].split()
    assert link[0] == "-shared" and len(link) == 6     # -o lib, 3 objects
    assert _build._lib_path(src).exists()
    assert not list((tmp_path / "build").glob("*.o"))


def test_persistent_counts_read_the_launcher_line(smoke):
    out = ("oracle mismatches: 0\n"
           "persistent cache: 2 hits / 0 misses -> /tmp/kc\nSMOKE OK\n")
    assert smoke._persistent_counts(out) == (2, 0)
    with pytest.raises(SystemExit):
        smoke._persistent_counts("SMOKE OK\n")


def test_radix_recorder_sees_both_kernel_entries(smoke):
    # a router row (40 wide) takes the fused top-k entry alone; a vocab row
    # past MAX_N takes the fused entry twice: its banks read in place, then
    # the manager pass with the banks' indices as its payload; under
    # _plain_threshold the same calls give the same values and indices
    # through the plain versions
    from repro_torch.kernels.radix_topk import ops as radix_ops
    from repro_torch.models import moe
    from repro_torch.serve import sampler
    rng = np.random.default_rng(0)
    probs = torch.softmax(torch.from_numpy(
        rng.normal(size=(6, 40)).astype(np.float32)), -1)
    logits = torch.from_numpy(rng.normal(size=(2, 40000)).astype(np.float32))
    calls = []
    with smoke._radix_recorder(calls):
        moe.radix_topk(probs, 8, device="cpu")
        sampler.radix_topk(logits, 16, device="cpu")
    assert [c["site"] for c in calls] == ["router", "sampler"]
    assert [[(e, tuple(x.shape), k, sorted(o)) for e, x, k, o in c["kernel"]]
            for c in calls] == [[("topk", (6, 40), 8, [])],
                                [("topk", (2, 40000), 16, ["bank"]),
                                 ("topk", (2, 48), 16, ["payload"])]]
    bank, manager = calls[1]["kernel"]
    assert bank[3]["bank"] == radix_ops.MAX_N
    assert manager[3]["payload"].dtype == torch.int32
    # a banked launch takes the block instance at any bank width
    assert radix_ops.instance(bank[1].shape[1], bank[3]["bank"]) == "block"
    assert radix_ops.instance(40000, radix_ops.NARROW_N) == "block"
    assert [smoke._launch_bytes(e, x, k, o) for e, x, k, o in
            calls[1]["kernel"]] == [2 * 40000 * 4 + 2 * 3 * 8 * 16,
                                    2 * 48 * 8 + 2 * 8 * 16]
    with smoke._plain_threshold():
        assert radix_ops.fused_topk is radix_ops._plain_topk
        for c in calls:
            vals, idx = radix_ops.radix_topk(c["x"], c["k"], device="cpu")
            assert torch.equal(vals, c["vals"]) and torch.equal(idx, c["idx"])
    assert radix_ops.fused_topk is not radix_ops._plain_topk
