"""The engine's stage spans (``repro_torch.obs.tracer.Stages``) on the CPU:

  * under a clock that advances a fixed step a read, one small engine run
    gives each stage its count, total and self time, and a stage's self
    time leaves out the stages it encloses;
  * under ``torch.profiler`` each stage of a traced engine call is a
    profiler event and a span of the tracer's export, on one clock; under
    an injected engine clock the export leaves the stage spans out;
  * with no profiler no range is opened;
  * through a live ``AsyncSortServe`` each request's ingest stamp lies
    between its submit and its bucket's close;
  * a failed ``submit`` keeps the time its stages spent.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch.sortserve import make_workload
from repro_torch.obs import Tracer
from repro_torch.obs.tracer import Stages
from repro_torch.sortserve import AsyncSortServe, EngineConfig, \
    SortServeEngine

STEP = 2.0 ** -10
ENGINE = ("sortserve.feed", "sortserve.bucket", "sortserve.emit",
          "sortserve.schedule", "sortserve.execute", "sortserve.scatter")
BACKEND = tuple(f"{b}.{part}" for b in ("colskip", "radix_topk")
                for part in ("h2d", "launch", "d2h"))


class StepClock:
    """A clock that advances by ``STEP`` on every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += STEP
        return self.t


def engine(**over):
    cfg = dict(backends=("colskip", "radix_topk"), tile_rows=4,
               min_bucket=8, banks=4, bank_width=256, bank_rows=4,
               sim_width_cap=256, cache_size=0, device="cpu")
    cfg.update(over)
    return SortServeEngine(EngineConfig(**cfg))


def workload(n=24, seed=7):
    return make_workload(n, min_len=8, max_len=128, seed=seed)


def test_nested_self_time_leaves_out_children():
    st = Stages()
    st.clock = StepClock()
    with st.stage("outer"):
        with st.stage("inner"):
            pass
        with st.stage("inner"):
            with st.stage("leaf"):
                pass
    sec = st.section()
    # a span's clock reads: its own two, and two for each span inside it
    assert sec["leaf"] == {"n": 1, "s": STEP, "self_s": STEP}
    assert sec["inner"]["n"] == 2
    assert sec["inner"]["s"] == pytest.approx(STEP + 3 * STEP)
    assert sec["inner"]["self_s"] == pytest.approx(STEP + 2 * STEP)
    assert sec["outer"]["s"] == pytest.approx(7 * STEP)
    assert sec["outer"]["self_s"] == pytest.approx(3 * STEP)


def test_engine_stages_under_a_step_clock():
    eng = engine()
    eng.stages.clock = StepClock()
    reqs = workload()
    eng.submit(reqs)
    telem = eng.telemetry()
    sec = telem["stages"]
    assert set(sec) == set(ENGINE) | set(BACKEND)
    pb = telem["per_backend"]
    tiles = sum(v["tiles"] for v in pb.values())
    n = {name: sec[name]["n"] for name in sec}
    # one feed and one drain, each a root with its emit; one bucket pass;
    # each call that closes tiles runs the scheduler once
    assert n["sortserve.feed"] == 2 and n["sortserve.emit"] == 2
    assert n["sortserve.bucket"] == 1
    assert 1 <= n["sortserve.schedule"] <= 2
    assert n["sortserve.execute"] == n["sortserve.scatter"] == tiles
    for b in ("colskip", "radix_topk"):
        for part in ("h2d", "launch", "d2h"):
            assert n[f"{b}.{part}"] == pb[b]["tiles"] > 0
    # under the step clock a span's self time is a step for itself and
    # one for each span it encloses directly
    children = {"sortserve.feed": ("sortserve.bucket", "sortserve.emit",
                                   "sortserve.schedule"),
                "sortserve.schedule": ("sortserve.execute",
                                       "sortserve.scatter"),
                "sortserve.execute": BACKEND}
    for name, row in sec.items():
        inside = sum(n[c] for c in children.get(name, ()))
        assert row["self_s"] == pytest.approx(STEP * (n[name] + inside))
        assert row["s"] >= row["self_s"] > 0
    # the root's time covers every other span: two reads a span
    assert sec["sortserve.feed"]["s"] == pytest.approx(
        STEP * (2 * sum(n.values()) - n["sortserve.feed"]))


def kineto_spans(prof, names):
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            out.setdefault(e.name(), []).append((e.start_ns() / 1e3,
                                                 e.end_ns() / 1e3))
    return {k: sorted(v) for k, v in out.items()}


class Bracketed:
    """A profiler range that reads the stage clock just before it opens
    and just after it closes, and logs the two reads under its name."""

    def __init__(self, rng, name, clock, log):
        self.rng, self.name, self.clock, self.log = rng, name, clock, log

    def __enter__(self):
        self.t = self.clock()
        self.rng.__enter__()

    def __exit__(self, *exc):
        self.rng.__exit__(*exc)
        self.log.setdefault(self.name, []).append((self.t, self.clock()))


DESCHEDULED_US = 25     # a range opens or closes in a few microseconds


def test_profiler_ranges_and_tracer_spans_share_a_clock():
    from torch.profiler import ProfilerActivity, profile
    tracer = Tracer()
    eng = engine(tracer=tracer)
    eng.submit(workload(seed=1))                # warm: launchers built
    warm = len(tracer.stage_spans)
    # the test's own clock reads around each range: the profiler stamps a
    # range while it opens (closes), so its stamp lies between the read
    # before the opening and the span's start (the span's end and the
    # read after the closing)
    st, brackets = eng.stages, {}
    rng = st._range
    st._range = lambda name: Bracketed(rng(name), name, st.clock, brackets)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.submit(workload(seed=2))
    doc = tracer.export()
    assert doc["otherData"]["clock"] == "unix_us"
    anchor = doc["otherData"]["anchor"]

    def unix_us(t):
        return ((t - anchor["perf_counter_ns"] / 1e9) * 1e6
                + anchor["time_ns"] / 1e3)

    spans = {}
    stage_events = [ev for ev in doc["traceEvents"]
                    if ev.get("pid") == 3 and ev["ph"] == "X"]
    for ev in stage_events[warm:]:              # the profiled call's
        spans.setdefault(ev["name"], []).append(
            (ev["ts"], ev["ts"] + ev["dur"]))
    names = set(ENGINE) | set(BACKEND)
    assert set(spans) == names
    assert set(brackets) == names
    kin = kineto_spans(prof, names)
    assert set(kin) == names
    for name in names:
        ours = sorted(spans[name])
        outer = sorted((unix_us(t0), unix_us(t1)) for t0, t1 in
                       brackets[name])
        assert len(ours) == len(kin[name]) == len(outer), name
        for (a0, a1), (b0, b1), (o0, o1) in zip(ours, kin[name], outer):
            assert o0 <= a0 and a1 <= o1, name
            if a0 - o0 < DESCHEDULED_US and o1 - a1 < DESCHEDULED_US:
                assert abs(a0 - b0) < 50 and abs(a1 - b1) < 50, (
                    name, a0 - b0, a1 - b1)
            else:
                # the thread was descheduled between a profiler stamp and
                # the span's clock read: the stamp lies in the interval
                # the test's reads bracket, within 50 us of it
                assert o0 - 50 < b0 < a0 + 50, (name, a0 - b0, a0 - o0)
                assert a1 - 50 < b1 < o1 + 50, (name, a1 - b1, o1 - a1)


def test_engine_clock_export_leaves_stage_spans_out():
    tracer = Tracer()
    eng = SortServeEngine(EngineConfig(
        backends=("colskip", "radix_topk"), tile_rows=4, min_bucket=8,
        banks=4, bank_width=256, bank_rows=4, sim_width_cap=256,
        cache_size=0, device="cpu", tracer=tracer), clock=StepClock())
    eng.submit(workload(seed=3))
    assert tracer.stage_spans                    # recorded, but on another
    doc = tracer.export()                        # axis than the chains
    assert doc["otherData"]["clock"] == "engine"
    assert not [ev for ev in doc["traceEvents"] if ev.get("pid") == 3]
    assert [ev for ev in doc["traceEvents"] if ev.get("pid") == 1
            and ev["ph"] == "X"]


def test_no_range_without_a_profiler(monkeypatch):
    eng = engine()
    opened = []
    real = eng.stages._range

    def counting(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(eng.stages, "_range", counting)
    eng.submit(workload())
    assert opened == []
    assert eng.telemetry()["stages"]["sortserve.feed"]["n"] == 2
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        eng.submit(workload(seed=8))
    assert "sortserve.feed" in opened and "colskip.launch" in opened


def test_ingest_lies_between_submit_and_bucket():
    tracer = Tracer()
    eng = engine(tracer=tracer)
    front = AsyncSortServe(eng, max_batch=8, max_wait_ms=2.0)
    try:
        reqs = workload(32, seed=11)
        futs = [front.submit(r) for r in reqs]
        for f in futs:
            f.result(timeout=60)
    finally:
        front.close()
    rids = {r.request_id for r in reqs}
    chains = [c for c in tracer.chains if c["rid"] in rids]
    assert len(chains) == len(reqs)
    for c in chains:
        assert c["t_feed"] <= c["t_ingest"] <= c["t_bucket"] <= c["t_done"]
    collect = eng.telemetry()["stages"]["frontdoor.collect"]
    assert collect["n"] > 0 and collect["s"] >= collect["self_s"] > 0
    # the chain's front-door wait is its own span inside the request's (to
    # the export's resolution: epoch microseconds in a float, a quarter)
    doc = tracer.export()
    waits = [ev for ev in doc["traceEvents"] if ev["name"] == "frontdoor"]
    assert {ev["tid"] for ev in waits} <= rids
    by_rid = {c["rid"]: c for c in chains}
    for ev in waits:
        c = by_rid[ev["tid"]]
        assert ev["dur"] == pytest.approx((c["t_ingest"] - c["t_feed"]) * 1e6,
                                          abs=0.5)


def test_failed_submit_keeps_stage_time():
    eng = engine(backends=("colskip",))
    be = eng.backends[0]

    def broken(tile):
        raise RuntimeError("broken machine")
    be.run = broken
    reqs = [r for r in workload() if r.op in ("sort", "argsort")]
    with pytest.raises(RuntimeError):
        eng.submit(reqs)
    sec = eng.telemetry()["stages"]
    assert eng.telemetry()["requests"] == 0          # counters rolled back
    assert sec["sortserve.execute"]["n"] >= 1
    assert sec["sortserve.feed"]["n"] == 1
