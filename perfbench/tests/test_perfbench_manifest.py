"""BENCHMARK.json: its form, and that a configuration, a traffic mix, a
metric and a cell are found by name from new files and entries alone."""

import json
import re

import pytest

from _small import REPO, small_root
from perfbench import harness

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
PROGRAM = ("build", "snapshot", "report", "check", "validate", "control")


def test_manifest_form():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "perfbench/run.py"]
    assert m["paths"] == ["perfbench"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    names = [c["name"] for c in m["configs"]]
    names += [w["name"] for w in m["workloads"]]
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"]:
        assert set(x) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    for x in m["per_layer"]:
        assert set(x) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert x["moves"] in e2e and LINE.match(x["layer"])
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in x["workloads"]:           # each cell reports `moves`
            assert cell in e2e[x["moves"]].get("workloads", [cell])
        if x["name"].endswith("_roofline") or "roofline" in x["name"]:
            assert x["unit"] == "%"
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    on_four = [w["name"] for w in m["workloads"] if w["chips"] == 4]
    assert len(on_four) <= max(1, len(m["workloads"]) // 4), on_four
    for w in m["workloads"]:
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert (REPO / "perfbench/traffic" / f"{w['traffic']}.json").is_file()
        reported = harness.cell_metrics(m, w["name"], "end_to_end")
        assert "setup_s" in [x["name"] for x in reported]
        assert len(reported) >= 2
        assert harness.cell_metrics(m, w["name"], "per_layer")
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in m["configs"]:
        assert c["file"].startswith("perfbench/")
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        # each key cut from the source is listed in the configuration's
        # own file, under its `reduced`, beside the published value
        published = json.loads((REPO / c["file"]).read_text()).get(
            "reduced", {})
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in published for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in m["workloads"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_resolves(cell):
    found = harness.find_cell(MANIFEST, cell)
    config = harness.load_config(REPO, MANIFEST, found["config"])
    mix = harness.load_mix(REPO, found["traffic"])
    gen = harness.generator(REPO, mix["kind"])
    assert all(hasattr(gen, f) for f in ("prepare", "warm", "drive"))
    program = harness.load_program(REPO, MANIFEST, found["config"])
    assert all(callable(getattr(program, f)) for f in PROGRAM)
    program.validate(config)
    for section in ("end_to_end", "per_layer"):
        for m in harness.cell_metrics(MANIFEST, cell, section):
            assert callable(harness.metric_reader(REPO, m["name"]).read)


def test_new_files_and_entries_are_found(tmp_path):
    """A configuration, a mix, a metric and a cell added as files and
    manifest entries only: the harness finds each by its name."""
    root = small_root(tmp_path)
    pb = root / "perfbench"
    config = json.loads((pb / "configs/colskip-n1024-w32-k2.json").read_text())
    config["name"] = "colskip-n1024-w32-k3"
    (pb / "configs/colskip-n1024-w32-k3.json").write_text(json.dumps(config))
    mix = json.loads((pb / "traffic/uniform1024.backlog.json").read_text())
    mix["dataset"] = "kruskal"
    (pb / "traffic/kruskal1024.backlog.json").write_text(json.dumps(mix))
    (pb / "metrics/requests_per_call.py").write_text(
        "def read(ctx):\n    return float(ctx.mix['batch'])\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": config["name"], "source": "x",
                         "file": "perfbench/configs/colskip-n1024-w32-k3.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "csk3.kruskal1024.backlog",
                           "config": config["name"],
                           "traffic": "kruskal1024.backlog", "chips": 1,
                           "why": "x"})
    m["per_layer"].append({"name": "requests_per_call", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "client", "moves": "elems_per_s",
                           "workloads": ["csk3.kruskal1024.backlog"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    man = harness.load_manifest(root)
    cell = harness.find_cell(man, "csk3.kruskal1024.backlog")
    assert harness.load_config(root, man, cell["config"])["name"] == \
        "colskip-n1024-w32-k3"
    assert harness.load_mix(root, cell["traffic"])["dataset"] == "kruskal"
    names = [x["name"] for x in harness.cell_metrics(man, cell["name"],
                                                     "per_layer")]
    assert "requests_per_call" in names
    reader = harness.metric_reader(root, "requests_per_call")
    assert reader.read(type("Ctx", (), {"mix": mix})) == float(mix["batch"])


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(harness.RunError):
        harness.find_cell(MANIFEST, "no.such.cell")
    with pytest.raises(harness.RunError):
        harness.load_mix(REPO, "no.such.mix")
    with pytest.raises(harness.RunError):
        harness.metric_reader(REPO, "no_such_metric")


def test_program_names_are_refused(tmp_path):
    """A configuration that names no program, or a program with no module,
    is refused with the configuration's file named."""
    root = small_root(tmp_path)
    file = "perfbench/configs/colskip-n1024-w32-k2.json"
    config = json.loads((root / file).read_text())
    for program in (None, "no_such_program", "../harness"):
        config.pop("program", None)
        if program is not None:
            config["program"] = program
        (root / file).write_text(json.dumps(config))
        with pytest.raises(harness.RunError, match=file):
            harness.load_program(root, MANIFEST, "colskip-n1024-w32-k2")


def test_sort_program_validates_its_configuration():
    program = harness.load_program(REPO, MANIFEST, "colskip-n1024-w32-k2")
    config = harness.load_config(REPO, MANIFEST, "colskip-n1024-w32-k2")
    del config["guarantees"]["serves"]["kmin"]
    with pytest.raises(ValueError, match="kmin"):
        program.validate(config)
    config = harness.load_config(REPO, MANIFEST, "colskip-n1024-w32-k2")
    del config["state_k"]
    with pytest.raises(ValueError, match="state_k"):
        program.validate(config)
