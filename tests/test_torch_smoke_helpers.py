"""The CPU-side helpers of ``chip_smoke.py`` that gate and price a chip run.

  * ``register_path_spills`` reads the spill bytes of the packed colskip
    kernel's register-path instances (WPL 1 and 2) from an ``-Xptxas -v``
    report and ignores every other kernel, so a spill there fails the run;
  * ``_searches`` counts the min searches a full sort of each row makes
    (its distinct values), the factor of the restated colskip bound;
  * the build keeps each library's ``-Xptxas -v`` report beside it, so a
    run that finds the library built still reads the spills.
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
