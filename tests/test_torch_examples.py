"""The port's twins of ``examples/*.py`` run on the CPU and pass their
references' checks.

Each twin runs with ``--device cpu`` in a subprocess of its own working
directory (the examples write their artifacts there), all five at once,
each under a timeout; a test per example reads its exit code and output.
"""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "sort_service", "trace_requests", "fleet_serve",
            "fleet_view")
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    procs = {}
    for name in EXAMPLES:
        cwd = tmp_path_factory.mktemp(name)
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / "torch" / f"{name}.py"),
             "--device", "cpu"], cwd=cwd, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE), cwd)
    out = {}
    for name, (proc, cwd) in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        out[name] = (proc.returncode, stdout, stderr, cwd)
    return out


def _ok(runs, name):
    rc, stdout, stderr, cwd = runs[name]
    assert rc == 0, stderr[-3000:]
    return stdout, cwd


def test_quickstart(runs):
    out, _ = _ok(runs, "quickstart")
    assert "baseline 12 CRs, column-skipping 7 CRs (paper: 12 vs 7)" in out
    assert "cycles identical: True" in out
    assert "[cpu] the §III machine reproduces cycles exactly: " in out
    assert "== torch.topk" in out


def test_sort_service(runs):
    out, _ = _ok(runs, "sort_service")
    assert "verify failures: 0" in out
    assert "all same tile shape: True" in out
    assert "session: 12/12 served" in out


def test_trace_requests(runs):
    out, cwd = _ok(runs, "trace_requests")
    assert "[round 1] served 60 requests" in out
    assert "120 request chains" in out and "[calibration]" in out
    assert (cwd / "trace.json").exists()


def test_fleet_serve(runs):
    out, cwd = _ok(runs, "fleet_serve")
    assert "(oracle mismatches: 0)" in out
    assert "replica0 is quarantined" in out
    assert out.rstrip().endswith("OK")
    assert (cwd / "fleet_warm.json").exists()


def test_fleet_view(runs):
    out, cwd = _ok(runs, "fleet_view")
    assert "requests=80 (= 30 + 50)" in out
    assert "ALERTING" in out and "ALERT instant(s)" in out
    for name in ("snapshot_engine-a.json", "fleet_metrics.prom",
                 "fleet_trace.json"):
        assert (cwd / name).exists(), name
