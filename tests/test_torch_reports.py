"""The port's report entry points against the reference's scripts.

``repro_torch.launch.calibration_report`` and ``repro_torch.launch.slo_report``
are the twins of ``scripts/calibration_report.py`` and
``scripts/slo_report.py`` (loaded here by file path):

  * ``render`` prints the same bytes and returns the same exit code on
    seeded tables;
  * under one fake clock (each read advances it by a fixed step) the live
    tables equal the reference's exactly, the clock included: both engines
    read it the same number of times, so ``wall_s`` and the burn rates
    agree as well as the counts;
  * telemetry JSONs and snapshots dumped by either package render through
    both: the calibration file mode byte-identical, the SLO fold as the
    reference's ``render`` prints the reference's own fold once each row
    carries its target's objective and windows (the reference's file mode
    renders ``fleet_view()["slo"]`` as it stands and raises ``KeyError:
    'objective'`` on any snapshot; the twin fills those fields in);
  * the command lines exit as the reference's would, and ``--device
    cuda`` without a card raises.
"""

import contextlib
import functools
import importlib.util
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.sortserve as ref_ss
import repro_torch.sortserve as port_ss
from repro.launch.sortserve import make_workload as ref_workload
from repro.obs import SLOTarget as RefSLOTarget
from repro_torch.launch import calibration_report, slo_report
from repro_torch.launch.sortserve import make_workload as port_workload
from repro_torch.obs import SLOTarget

from _torch_golden import GOLDEN_CFG

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEP_S = 0.002          # a fake-clock read; 4 of 12 live latencies within
                        # the 0.05 s target, 8 over it: the class alerts


@functools.lru_cache(maxsize=None)
def _ref_script(name: str):
    """``scripts/<name>.py`` as a module (the scripts are no package)."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class StepClock:
    """A clock that advances by ``STEP_S`` on every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        self.t += STEP_S
        return self.t


def _printed(fn, *args):
    """(stdout, return value) of ``fn(*args)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return buf.getvalue(), rc


# ----------------------------------------------------------------- render

def _calib_table(seed: int, backends, widths, int_keys=False) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for be in backends:
        cells = {}
        for w in widths:
            wall = float(rng.uniform(1e-5, 3.0))
            modeled = float(rng.uniform(1e-7, 1e-3))
            cells[w if int_keys else str(w)] = {
                "tiles": int(rng.integers(1, 5000)), "wall_s": wall,
                "modeled_s": modeled, "ratio": wall / modeled}
        out[be] = cells
    return out


CALIB_TABLES = {
    "empty": {},
    "one_backend": _calib_table(1, ["colskip"], [512]),
    # "1024" < "256" < "4096" < "64" as strings: rows go in int order
    "widths_sort_by_int": _calib_table(
        2, ["jaxsort", "colskip"], [64, 4096, 256, 1024, 16, 32768]),
    "int_keys": _calib_table(3, ["colskip_mesh", "colskip"],
                             [128, 8, 2048], int_keys=True),
    "many_backends": _calib_table(
        4, ["radix_topk", "colskip", "numpy", "colskip_mesh", "jaxsort"],
        [8, 100, 65536]),
}


@pytest.mark.parametrize("name", sorted(CALIB_TABLES))
def test_calibration_render_matches_reference(name, capsys):
    table = CALIB_TABLES[name]
    rc_ref = _ref_script("calibration_report").render(table)
    ref = capsys.readouterr().out
    rc = calibration_report.render(table)
    assert capsys.readouterr().out == ref
    assert rc == rc_ref == (1 if not table else 0)


def _slo_row(rng, alerting: bool, sli: str) -> dict:
    good, bad = (int(x) for x in rng.integers(0, 10000, 2))
    row = {"objective": float(rng.uniform(0.9, 0.9999)), "good": good,
           "bad": bad, "burn_long": float(rng.uniform(0, 200)),
           "burn_short": float(rng.uniform(0, 200)),
           "alerts": int(rng.integers(0, 9)), "alerting": alerting,
           "budget": float(rng.uniform(1e-4, 0.1))}
    if sli == "latency":
        row["threshold_s"] = float(rng.uniform(0.001, 1.0))
    return row


def _slo_table(seed: int, classes) -> dict:
    """``classes``: (name, latency alerting or None, shed alerting or None,
    with config)."""
    rng = np.random.default_rng(seed)
    out = {}
    for cls, lat, shed, cfg in classes:
        per = {}
        for sli, state in (("latency", lat), ("shed", shed)):
            if state is not None:
                per[sli] = _slo_row(rng, state, sli)
        if cfg:
            per["config"] = {"long_window_s": float(rng.uniform(10, 3600)),
                             "short_window_s": float(rng.uniform(1, 10)),
                             "burn_threshold": float(rng.uniform(1, 20))}
        out[cls] = per
    return out


SLO_TABLES = {
    "empty": {},
    "ok_with_config": _slo_table(5, [("live", False, False, True)]),
    "alerting_without_config": _slo_table(6, [("live", True, False, False)]),
    "classes_mixed": _slo_table(7, [
        ("interactive", False, True, True), ("batch", False, False, False),
        ("live", True, True, True), ("bulk", False, None, True),
        ("probe", None, None, False)]),
    "all_ok_no_config": _slo_table(8, [("a", False, False, False),
                                       ("b", False, False, False)]),
}


@pytest.mark.parametrize("name", sorted(SLO_TABLES))
def test_slo_render_matches_reference(name, capsys):
    table = SLO_TABLES[name]
    rc_ref = _ref_script("slo_report").render(table)
    ref = capsys.readouterr().out
    rc = slo_report.render(table)
    assert capsys.readouterr().out == ref
    alerting = any(row.get("alerting") for per in table.values()
                   for row in per.values())
    assert rc == rc_ref == (1 if not table or alerting else 0)


# ------------------------------------------------------------------- live

@pytest.fixture
def step_clocks(monkeypatch):
    """Both packages' engines, as the scripts import them at call time,
    built on a fresh :class:`StepClock` each."""
    monkeypatch.setattr(ref_ss, "SortServeEngine", functools.partial(
        ref_ss.SortServeEngine, clock=StepClock()))
    monkeypatch.setattr(port_ss, "SortServeEngine", functools.partial(
        port_ss.SortServeEngine, clock=StepClock()))


def test_live_calibration_table_equals_reference(step_clocks):
    ref = _ref_script("calibration_report").live_table(12, 0)
    port = calibration_report.live_table(12, 0, device="cpu")
    assert port == ref and port
    assert all(cell["tiles"] > 0 and cell["modeled_s"] > 0
               for cells in port.values() for cell in cells.values())
    assert _printed(calibration_report.render, port) == \
        _printed(_ref_script("calibration_report").render, ref)


def test_live_slo_table_equals_reference(step_clocks):
    ref = _ref_script("slo_report").live_slo(12, 0)
    port = slo_report.live_slo(12, 0, device="cpu")
    assert port == ref
    lat = port["live"]["latency"]
    assert (lat["good"], lat["bad"], lat["alerting"]) == (4, 8, True)
    text, rc = _printed(slo_report.render, port)
    assert (text, rc) == _printed(_ref_script("slo_report").render, ref)
    assert rc == 1


# ------------------------------------------------------------------ files

def _serve_and_dump(package: str, tmp: pathlib.Path) -> tuple:
    """Two SLO-armed engines of ``package`` (seeds 1 and 5), each serving
    two flushed sessions of class "live" (the second runs warm); each
    dumps its telemetry JSON and its snapshot.  Returns (telemetry paths,
    snapshot paths, each engine's live ``telemetry()["slo"]``)."""
    if package == "reference":
        engine_cls, workload = ref_ss.SortServeEngine, ref_workload
        cfg = ref_ss.EngineConfig(**GOLDEN_CFG, slo={
            "live": RefSLOTarget(p99_latency_s=0.05)})
    else:
        engine_cls, workload = port_ss.SortServeEngine, port_workload
        cfg = port_ss.EngineConfig(**GOLDEN_CFG, device="cpu", slo={
            "live": SLOTarget(p99_latency_s=0.05)})
    telems, snaps, live = [], [], []
    for name, seed in (("a", 1), ("b", 5)):
        engine = engine_cls(cfg, clock=StepClock())
        for rnd in range(2):
            session = engine.begin(traffic_class="live", strict=False)
            session.feed(workload(10, min_len=8, max_len=128,
                                  seed=seed + rnd), flush=True)
            session.drain()
        telems.append(str(tmp / f"{package}_{name}_telemetry.json"))
        snaps.append(str(tmp / f"{package}_{name}_snapshot.json"))
        engine.dump_telemetry(telems[-1])
        engine.dump_snapshot(snaps[-1], source=f"{package}-{name}")
        live.append(engine.telemetry()["slo"])
    return telems, snaps, live


def _ref_rows(paths) -> dict:
    """The reference's own fold of ``paths``, each row completed from its
    class's target as the live section derives it."""
    from repro.obs import merge_snapshots
    from repro.obs.aggregate import TelemetrySnapshot

    merged = merge_snapshots(TelemetrySnapshot.load(p) for p in paths)
    out = {}
    for cls, per in merged.fleet_view()["slo"].items():
        target = RefSLOTarget(**merged.slo[cls]["target"])
        rows = {sli: {**row, "objective": target.latency_objective
                      if sli == "latency" else 1.0 - target.shed_rate_target}
                for sli, row in per.items()}
        rows["latency"]["threshold_s"] = target.p99_latency_s
        rows["config"] = {"long_window_s": target.long_window_s,
                          "short_window_s": target.short_window_s,
                          "burn_threshold": target.burn_threshold}
        out[cls] = rows
    return out


@pytest.mark.parametrize("package", ["reference", "port"])
def test_dumped_files_render_identically(package, tmp_path):
    telems, snaps, live = _serve_and_dump(package, tmp_path)
    ref_cal, ref_slo = (_ref_script("calibration_report"),
                        _ref_script("slo_report"))
    for path in telems:
        text, rc = _printed(calibration_report.main, [path])
        assert (text, rc) == _printed(ref_cal.main, [path])
        assert rc == 0 and text.count("\n") > 1

    folded = slo_report.fleet_slo(snaps)
    assert folded == _ref_rows(snaps)
    text, rc = _printed(slo_report.main, snaps)
    assert (text, rc) == _printed(ref_slo.render, _ref_rows(snaps))
    # the fold's counts are the engines' summed, its latch their OR
    for sli in ("latency", "shed"):
        row = folded["live"][sli]
        for key in ("good", "bad", "alerts"):
            assert row[key] == sum(s["live"][sli][key] for s in live)
        assert row["alerting"] == any(s["live"][sli]["alerting"]
                                      for s in live)
    assert folded["live"]["latency"]["bad"] > 0
    # one snapshot folds to its engine's live section, burn rates aside
    # (they are evaluated at the snapshot's instant, not the section's)
    one = slo_report.fleet_slo(snaps[:1])["live"]
    burns = ("burn_long", "burn_short")
    assert {sli: {k: v for k, v in row.items() if k not in burns}
            for sli, row in one.items()} == \
        {sli: {k: v for k, v in row.items() if k not in burns}
         for sli, row in live[0]["live"].items()}
    # the reference's file mode renders the bare fleet view and fails
    with pytest.raises(KeyError, match="objective"):
        _printed(ref_slo.main, snaps)


# -------------------------------------------------------------------- CLI

def _start(module: str, *args):
    return subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.launch.{module}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def _finish(proc):
    out, err = proc.communicate(timeout=300)
    return proc.returncode, out, err


def test_cli_live_on_cpu_exits_as_reference():
    live = ("--live", "--device", "cpu", "--requests", "8")
    procs = [_start("calibration_report", *live),
             _start("slo_report", *live)]
    (rc, out, err), (slo_rc, slo_out, slo_err) = map(_finish, procs)
    assert rc == 0, err
    assert out.splitlines()[0].split() == \
        ["backend", "width", "tiles", "wall_s", "modeled_s", "ratio"]
    assert len(out.splitlines()) > 1
    # the reference's rule: 1 exactly when a row is alerting
    assert slo_rc == (1 if "ALERTING" in slo_out else 0), slo_err
    lines = slo_out.splitlines()
    assert lines[0].split()[:3] == ["class", "sli", "objective"]
    assert [ln.split()[:2] for ln in lines[1:3]] == [["live", "latency"],
                                                      ["live", "shed"]]


@pytest.mark.parametrize("module", ["calibration_report", "slo_report"])
def test_cli_without_arguments_exits_2(module, capsys):
    ref = _ref_script(module)
    with pytest.raises(SystemExit) as ref_exit:
        ref.main([])
    rc, _, err = _finish(_start(module))
    assert rc == ref_exit.value.code == 2
    assert "error: give" in err


@pytest.mark.parametrize("module", [calibration_report, slo_report],
                         ids=["calibration_report", "slo_report"])
def test_live_on_cuda_without_a_card_raises(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--live", "--device", "cuda", "--requests", "2"])
