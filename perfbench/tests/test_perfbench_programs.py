"""A program that is not the sorter, added as new files and manifest
entries only (its configuration, program module, generator, mix, reader
and cell), runs through the unchanged harness; and the harness loads no
module of the sort program to do so."""

import json
import subprocess
import sys
import textwrap

import pytest

from _small import REPO, small_root
from perfbench import harness

SEED = 2**31 + 7
CELL = "neg.f32.backlog"

PROGRAM = '''
"""A stand-in program: negates rows of float32 numbers."""

import numpy as np
import torch


class Negator:
    def __init__(self, device):
        self.device = device
        self.calls = 0

    def negate(self, rows):
        self.calls += 1
        return (-torch.from_numpy(rows).to(self.device)).cpu().numpy()


def validate(config):
    if int(config.get("n", 0)) < 1:
        raise ValueError("n")


def build(config, device, cache_dir, tracer):
    return Negator(device)


def snapshot(obj):
    return {"telemetry": {"calls": obj.calls}}


def report(obj, log):
    log(f"negator: {obj.calls} calls")


def check(window, config, marks, *, seed, device, log):
    answers = [(q, r) for q, r in zip(window["requests"],
                                      window["responses"]) if r is not None]
    wrong = sum(not np.array_equal(r, -q.payload) for q, r in answers)
    numbers = {"missing": len(window["requests"]) - len(answers),
               "wrong": wrong}
    return numbers, {"missing": 0, "wrong": 0}, {}


def control(obj, config):
    """The negation in float16, the precision below the configuration's."""
    inner = obj.negate
    obj.negate = lambda rows: inner(rows.astype(np.float16)).astype(
        np.float32)
'''

GENERATOR = '''
"""Closed loop of float32 rows for the stand-in program."""

from collections import namedtuple

import numpy as np

Req = namedtuple("Req", "payload n")


def prepare(mix, config, seed, seconds):
    rng = np.random.default_rng([int(seed), 9])
    rows = rng.standard_normal((int(mix["pool"]), int(config["n"])),
                               dtype=np.float32)
    return {"rows": rows, "batch": int(mix["batch"])}


def warm(plan, obj, hooks):
    obj.negate(plan["rows"][:plan["batch"]])


def drive(plan, obj, seconds, hooks):
    rows, batch = plan["rows"], plan["batch"]
    clock = hooks.clock
    requests, responses, t_due, t_done = [], [], [], []
    error = None
    hooks.opened()
    t0 = clock()
    end = t0 + seconds
    try:
        with hooks.span("window"):
            while clock() < end:
                at = [(len(requests) + j) % len(rows) for j in range(batch)]
                t = clock()
                with hooks.span("feed"):
                    out = obj.negate(rows[at])
                done = clock()
                for r, i in enumerate(at):
                    requests.append(Req(rows[i], rows.shape[1]))
                    responses.append(out[r])
                    t_due.append(t)
                    t_done.append(done)
    except Exception as exc:
        error = exc
    t_loop = clock()
    hooks.closed()
    return {"requests": requests, "responses": responses,
            "t_due": np.asarray(t_due), "t_done": np.asarray(t_done),
            "t0": t0, "t_end": end, "t_loop": t_loop,
            "errors": [None] * len(requests), "error": error}
'''

READER = '''
"""Calls of the stand-in program a second of the window."""


def read(ctx):
    calls = ctx.delta("calls")
    return calls / ctx.loop_s() if calls else None
'''


def stub_root(tmp):
    """A small copy of the benchmark with the stand-in program's files and
    entries added."""
    root = small_root(tmp)
    pb = root / "perfbench"
    (pb / "programs/negate.py").write_text(PROGRAM)
    (pb / "traffic/negate_loop.py").write_text(GENERATOR)
    (pb / "metrics/negate_calls.py").write_text(READER)
    (pb / "configs/negate-f32.json").write_text(json.dumps(
        {"name": "negate-f32", "program": "negate", "n": 256}))
    (pb / "traffic/f32.backlog.json").write_text(json.dumps(
        {"kind": "negate_loop", "batch": 8, "pool": 64}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "negate-f32", "source": "x",
                         "file": "perfbench/configs/negate-f32.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": CELL, "config": "negate-f32",
                           "traffic": "f32.backlog", "chips": 1, "why": "x"})
    e2e = {x["name"]: x for x in m["end_to_end"]}
    e2e["elems_per_s"]["workloads"].append(CELL)
    m["per_layer"].append({"name": "negate_calls", "unit": "calls/s",
                           "better": "higher", "source": "program_counter",
                           "layer": "stand-in", "moves": "elems_per_s",
                           "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return stub_root(tmp_path_factory.mktemp("stub"))


def run(root, patch=None, trace=False):
    return harness.run_cell(root, CELL, SEED, 0.5, trace, device="cpu",
                            patch=patch, log=lambda msg: None)


@pytest.mark.parametrize("trace", [False, True])
def test_another_program_runs_through_the_harness(root, trace):
    result = run(root, trace=trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"missing": {"value": 0, "limit": 0},
                                "wrong": {"value": 0, "limit": 0}}
    wanted = {"negate_calls"} if trace else {"setup_s", "elems_per_s"}
    assert set(result["metrics"]) == wanted
    assert all(m["value"] > 0 for m in result["metrics"].values())


def altered(obj, config):
    """An answer altered where it is produced: one number of each call."""
    inner = obj.negate

    def negate(rows):
        out = inner(rows)
        out[0, 0] += 1.0
        return out
    obj.negate = negate


@pytest.mark.parametrize("fault", ["altered", "control"])
def test_another_program_is_checked(root, fault):
    manifest = harness.load_manifest(root)
    config = harness.load_config(root, manifest, "negate-f32")
    program = harness.load_program(root, manifest, "negate-f32")
    program.validate(config)
    patch = altered if fault == "altered" else program.control
    result = run(root, patch=lambda obj: patch(obj, config))
    assert not result["correct"]
    assert result["attempted"] > 0
    assert result["checks"]["wrong"]["value"] > 0


def test_the_harness_loads_no_sort_module(tmp_path):
    """Importing the harness, and running the stand-in program's cell,
    loads neither the sort service nor its reference check."""
    root = stub_root(tmp_path)
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
        import perfbench.harness as harness
        SORT = ("repro_torch.sortserve", "perfbench.reference.verify",
                "perfbench.programs.sortserve")
        imported = sorted(set(SORT) & set(sys.modules))
        r = harness.run_cell({str(root)!r}, {CELL!r}, 5, 0.5, False,
                             device="cpu", log=lambda msg: None)
        print(json.dumps({{"imported": imported, "correct": r["correct"],
                          "ran": sorted(set(SORT) & set(sys.modules))}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"imported": [], "correct": True, "ran": []}
