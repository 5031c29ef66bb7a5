"""The benchmark of ``repro_torch``: one run of one cell.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs the cell named in ``BENCHMARK.json`` and prints one
JSON line (the last of standard output).  Everything that belongs to one
configuration, program, traffic mix or metric is found by its name:

* a cell's configuration is ``configs/<config>.json`` (the manifest's
  ``file``): the program's settings and the guarantees its check holds
  the answers to, and under ``program`` the name of its program;
* that program is ``programs/<program>.py`` (for example ``"sortserve"``);
* its traffic is ``traffic/<traffic>.json``, whose ``kind`` names the
  generator module ``traffic/<kind>.py`` (``prepare``, ``warm``,
  ``drive``);
* each metric is ``metrics/<name>.py``, whose ``read(ctx)`` returns the
  number or None when the run has nothing for it to read.

A program module provides:

* ``build(config, device, cache_dir, tracer)``: the object under test,
  which the generator's ``warm`` and ``drive`` receive; ``cache_dir`` is
  where its kernel libraries are kept (None on the CPU), ``tracer`` the
  program's request tracer or None;
* ``snapshot(obj)``: the dict kept at the window's open and close (the
  harness adds ``"t"``, its clock); it holds ``"telemetry"``, the counters
  that ``Context.delta`` reads, and whatever else the readers read;
* ``report(obj, log)``: writes the lines logged once the window closed,
  before the program's state is freed;
* ``check(window, config, marks, *, seed, device, log)``: run once the
  program's state is freed, returns ``(numbers, limits, info)``: each
  compared number, each its limit (the run is correct when every number
  is at most its limit), and ``info``, the fields of the readers'
  ``Context`` that only the check works out; ``numbers["missing"]`` is
  the run's failed count;
* ``validate(config)``: raises ValueError on a configuration it cannot
  run (the tests call it);
* ``control(obj, config)``: puts the program's control in place once set-up
  is done, which the check must read as not correct (``control.py``).

A generator's ``prepare(mix, config, seed, seconds)`` makes the run's
inputs from the seed; ``warm(plan, obj, hooks)`` runs every shape the
window will; ``drive(plan, obj, seconds, hooks)`` calls ``hooks.opened()``,
runs the window inside the span ``window`` and calls ``hooks.closed()``,
then returns the window's record:

* ``requests``: one record a request offered, whose ``n`` is the elements
  it asks of the program (the keys of a sort request, the tokens a
  generation request generates), the unit of ``elems_per_s``;
* ``responses``: the answer of each, None where none came;
* ``t_due``, ``t_done``: numpy arrays of each request's due time and the
  time its answer came (NaN where none came), on ``hooks.clock``;
* ``t0``, ``t_end``, ``t_loop``: the window's open, its planned close
  (``t0 + seconds``) and the time its loop ended;
* ``errors``: each request's error or None; ``error``: what stopped the
  window, or None;
* and what the program's check reads besides (``client_s``, the seconds
  the harness's client spent outside the program's calls, is logged).

A run: set-up (imports, the card, the inputs from the seed, the program,
every launcher and shape of the cell warmed) is ``setup_s``; then the
window of ``--seconds``; then, with the program's state freed, its check.
``--trace 1`` runs the window under ``torch.profiler`` and reports the
per-layer metrics in place of the end-to-end ones.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import importlib.util
import json
import os
import sys
import time
from numbers import Integral
from pathlib import Path

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACER_SLACK = 4096


class RunError(RuntimeError):
    """The run cannot produce a result; the message says why."""


# ---------------------------------------------------------------- manifest
def load_manifest(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(manifest: dict, workload: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == workload:
            return cell
    raise RunError(f"no workload {workload!r} in BENCHMARK.json; have "
                   f"{[c['name'] for c in manifest['workloads']]}")


def load_config(root: Path, manifest: dict, name: str) -> dict:
    for entry in manifest["configs"]:
        if entry["name"] == name:
            with open(Path(root) / entry["file"]) as f:
                return json.load(f)
    raise RunError(f"no configuration {name!r} in BENCHMARK.json")


def load_mix(root: Path, traffic: str) -> dict:
    path = Path(root) / "perfbench" / "traffic" / f"{traffic}.json"
    if not path.is_file():
        raise RunError(f"no traffic mix file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, folder: str, name: str):
    """The module ``<folder>/<name>.py`` under ``root``'s perfbench, as
    ``perfbench.<folder>.<name>`` (its relative imports resolve in the
    package ``perfbench.<folder>``)."""
    path = Path(root) / "perfbench" / folder / f"{name}.py"
    if not (name.isidentifier() and path.is_file()):
        raise RunError(f"no module {path}")
    qual = f"perfbench.{folder}.{name}"
    spec = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qual] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[qual]
        raise
    return mod


def generator(root: Path, kind: str):
    """The traffic generator ``traffic/<kind>.py``."""
    return load_module(root, "traffic", kind)


def load_program(root: Path, manifest: dict, name: str):
    """The program module that configuration ``name`` names under its key
    ``program``: ``programs/<program>.py``."""
    program = load_config(root, manifest, name).get("program")
    file = next(e["file"] for e in manifest["configs"] if e["name"] == name)
    if not isinstance(program, str):
        raise RunError(f"{file} names no program (its key 'program')")
    try:
        return load_module(root, "programs", program)
    except RunError as exc:
        raise RunError(f"{file} names the program {program!r}: {exc}") \
            from None


def metric_reader(root: Path, name: str):
    """The module ``metrics/<name>.py`` under ``root``'s perfbench."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no reader {path} for metric {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, section: str) -> list[dict]:
    """The manifest's metrics of ``section`` that ``cell`` reports."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


# ------------------------------------------------------------------- hooks
class GcWatch:
    """Pauses of the interpreter's garbage collector while armed."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.paused_s = 0.0
        self.longest_s = 0.0
        self._t = None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            dt = time.perf_counter() - self._t
            self.paused_s += dt
            self.longest_s = max(self.longest_s, dt)
            self.count[info["generation"]] += 1
            self._t = None


class Hooks:
    """What a generator's ``warm``/``drive`` call back into: the clock,
    spans (profiler ranges in a traced run), the window's open and close
    (the program's snapshots), and a device synchronise."""

    def __init__(self, snapshot, device: str, traced: bool):
        self.snapshot = snapshot
        self.device = device
        self.traced = traced
        self.clock = time.perf_counter
        self.marks: dict = {}

    def span(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def synchronize(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    def _snapshot(self) -> dict:
        snap = self.snapshot()
        snap["t"] = self.clock()
        return snap

    def opened(self) -> None:
        self.marks["open"] = self._snapshot()
        self.gc = GcWatch()
        gc.callbacks.append(self.gc)

    def closed(self) -> None:
        gc.callbacks.remove(self.gc)
        self.synchronize()
        self.marks["close"] = self._snapshot()


# --------------------------------------------------------------------- run
def _log_window(log, window: dict, gcw: GcWatch) -> None:
    """Standard-error lines that say how the window went."""
    import numpy as np
    log(f"garbage collector in the window: {gcw.count} collections by "
        f"generation, {gcw.paused_s:.4f} s paused, longest "
        f"{gcw.longest_s:.4f} s")
    lat = (window["t_done"] - window["t_due"]) * 1e3
    lat = lat[np.isfinite(lat)]
    if lat.size:
        q = np.percentile(lat, [50, 90, 95, 99, 100])
        log("latency ms (response time - due time): p50 {:.3f}, p90 {:.3f}, "
            "p95 {:.3f}, p99 {:.3f}, max {:.3f}".format(*q))
    log(f"window: {window['t_loop'] - window['t0']:.4f} s from its open to "
        f"its close, {window.get('client_s', 0.0):.4f} s of it in the "
        "harness's client outside the program's calls")
    errors = [e for e in window["errors"] if e is not None]
    if errors or window["error"] is not None:
        log(f"{len(errors)} requests failed (first: {errors[:1]}); "
            f"window error: {window['error']!r}")


def process_age_s() -> float:
    """Seconds since this process started: the kernel's start stamp
    (clock ticks since boot) against the boot-time clock; the interpreter
    start of ``run.py`` where that cannot be read."""
    fallback = time.time() - START_WALL
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return fallback
    return age if fallback <= age <= fallback + 60 else fallback


START_WALL = time.time()


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", patch=None,
             log=None) -> dict:
    """One run; returns the result line as a dict.  ``patch(obj)``, if
    given, alters the program's timed path once set-up is done (the
    control and the fault tests)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    root = Path(root)
    manifest = load_manifest(root)
    cell = find_cell(manifest, workload)
    config = load_config(root, manifest, cell["config"])
    program = load_program(root, manifest, cell["config"])
    mix = load_mix(root, cell["traffic"])
    section = "per_layer" if trace else "end_to_end"
    wanted = cell_metrics(manifest, workload, section)
    readers = {m["name"]: metric_reader(root, m["name"]) for m in wanted}
    needs = set().union(*(getattr(r, "NEEDS", set())
                          for r in readers.values()))

    import torch
    if device == "cuda":
        torch.cuda.init()
    phases = {"start_to_imports": process_age_s()}
    gen = generator(root, mix["kind"])
    plan = gen.prepare(mix, config, seed, seconds)
    phases["prepare"] = process_age_s()
    tracer = None
    if "tracer" in needs:
        from repro_torch.obs import Tracer
        expect = int(float(mix.get("rate_per_s", 0)) * seconds)
        tracer = Tracer(capacity=expect + TRACER_SLACK)
    cache_dir = (str(root / "build" / "repro_torch")
                 if device == "cuda" else None)
    obj = program.build(config, device, cache_dir, tracer)
    phases["build"] = process_age_s()
    hooks = Hooks(functools.partial(program.snapshot, obj), device, trace)
    gen.warm(plan, obj, hooks)
    if device == "cuda":
        torch.cuda.synchronize()
    phases["warm"] = process_age_s()
    if patch is not None:
        patch(obj)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = process_age_s()
    log("set-up, seconds since the process started: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()) + f", window {setup_s:.3f}")
    window = gen.drive(plan, obj, seconds, hooks)
    if prof is not None:
        hooks.synchronize()
        prof.__exit__(None, None, None)
    late = forbidden_modules()
    if late:
        raise RunError(f"modules {late} loaded by the time the window closed")
    if device == "cuda":
        memory_peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name(0)
    else:
        memory_peak, kind = 0, "cpu"
    program.report(obj, log)

    _log_window(log, window, hooks.gc)

    from perfbench.metrics import _lib
    trace_info = _lib.read_trace(prof) if prof is not None else None
    if trace_info is not None:
        log(f"trace: busy {trace_info['busy_s']:.4f} s of "
            f"{trace_info['window_s']:.4f} s; harness spans "
            f"{trace_info['spans_s']}")
    marks = dict(hooks.marks)
    del obj, hooks, prof, plan      # the program's state, freed
    if device == "cuda":
        torch.cuda.empty_cache()

    numbers, limits, info = program.check(window, config, marks, seed=seed,
                                          device=device, log=log)
    failed = int(numbers["missing"])
    correct = (window["error"] is None
               and all(numbers[k] <= limits[k] for k in limits))

    ctx = _lib.Context(window=window, marks=marks, config=config, mix=mix,
                       seconds=seconds, setup_s=setup_s, trace=trace_info,
                       tracer=tracer, **info)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": kind,
           "count": int(cell["chips"]) if device == "cuda" else 1,
           "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": len(window["requests"]),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace_info is not None:
        dev["busy_s"] = trace_info["busy_s"]
        dev["window_s"] = trace_info["window_s"]
        result["breakdown"] = {"device_ops": trace_info["device_ops"],
                               "idle_gaps": trace_info["idle_gaps"]}
    result["checks"] = {k: {"value": _plain(numbers[k]), "limit": limits[k]}
                        for k in limits}
    late = forbidden_modules()
    if late:
        raise RunError(f"modules {late} loaded in the process")
    return result


def _plain(x):
    """A compared number as JSON holds it: a whole number stays whole."""
    return int(x) if isinstance(x, Integral) else float(x)


def main(argv=None, root: Path | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root) if root is not None else PKG.parent
    try:
        cell = find_cell(load_manifest(root), args.workload)
        if not (root / "src" / "repro_torch" / "__init__.py").is_file():
            raise RunError(f"the program, {root}/src/repro_torch, is missing")
        import torch
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {cell['chips']}")
        result = run_cell(root, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except (RunError, OSError) as exc:
        print(f"perfbench: {exc}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
