"""The port's fleet (``repro_torch.sortserve.fleet``) on the CPU.

The surface of ``tests/test_fleet.py`` on the port's ``FleetRouter``
(replicas built with ``device="cpu"``):

  * every request served exactly once or failed with a typed error, under
    random batches, replica counts and a tight shed watermark;
  * routing deterministic given a seed; the fleet snapshot equal to the
    ``merge_snapshots`` fold of the replicas';
  * a replica restored from a warm-state artifact serves the seed-21
    golden workload byte-identical to a cold one and to
    ``tests/golden/continuous_telemetry.json`` (``tests/_torch_golden.py``);
    save -> load -> save is byte-stable; bad artifacts raise
    ``WarmStateError``; merged artifacts stay inside the replicas' envelope;
  * a killed replica fails over exactly once and is reinstated; a shed
    redirects to a sibling; a rolling restart sheds nothing.

And the artifact crosses between the packages: one saved by the
reference's ``repro.sortserve.fleet`` applies in the port with the same
counts as in the reference (and prewarms the port's launchers), the
port's loads in the reference, and a canonical re-save is byte-identical
both ways.
"""

import dataclasses
import itertools
import json

import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from _torch_golden import GOLDEN, GOLDEN_CFG, _digest, golden_payload, golden_text

from repro.sortserve import EngineConfig as RefEngineConfig
from repro.sortserve import SortServeEngine as RefEngine
from repro.sortserve import fleet as ref_fleet
from repro_torch.launch.sortserve import check_against_oracle, make_workload
from repro_torch.obs.aggregate import merge_snapshots
from repro_torch.sortserve import (
    WARM_STATE_VERSION,
    EngineConfig,
    FaultPlan,
    FleetRouter,
    FleetSaturated,
    NoReplicaAvailable,
    RecoveryPolicy,
    SortServeEngine,
    WarmStateError,
    WatermarkPolicy,
    load_warm_state,
    merge_warm_states,
    save_warm_state,
)
from repro_torch.sortserve import request as request_mod
from repro_torch.sortserve.backends import EXECUTOR_CACHE

SEED21 = dict(n_requests=40, min_len=8, max_len=128, seed=21)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> float:
        self.t += dt
        return self.t


def make_engine(clock=None, **over):
    """The golden engine (test_continuous.make_engine) on the CPU."""
    return SortServeEngine(EngineConfig(**{**GOLDEN_CFG, "device": "cpu",
                                           **over}), clock=clock)


def tiny_engine(clock=None, **over):
    """A fast numpy-only replica for routing/failover cases."""
    cfg = dict(backends=("numpy",), tile_rows=2, banks=2, bank_width=64,
               bank_rows=2, sim_width_cap=64, cache_size=0, device="cpu")
    cfg.update(over)
    return SortServeEngine(EngineConfig(**cfg), clock=clock)


def make_fleet(n, seed=0, clock=None, engine=tiny_engine, **router_kw):
    return FleetRouter([engine(clock=clock) for _ in range(n)], seed=seed,
                       clock=clock, **router_kw)


def assert_exactly_once(reqs, resps, fails):
    served = {r.request_id for r in resps if r is not None}
    failed = {req.request_id for req, _ in fails}
    assert served | failed == {req.request_id for req in reqs}
    assert not served & failed
    assert len(fails) == len(failed)
    for req, resp in zip(reqs, resps):
        if resp is not None:
            assert resp.request_id == req.request_id
            assert check_against_oracle(req, resp)
    for _req, exc in fails:
        assert isinstance(exc, (FleetSaturated, NoReplicaAvailable))


# ------------------------------------------------------------ property sweep
@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2 ** 16), st.sampled_from([1, 2, 3]),
       st.integers(1, 12), st.booleans())
def test_every_request_served_once_or_typed(seed, n_replicas, n_requests,
                                            tight):
    over = {}
    if tight:
        over["admission"] = WatermarkPolicy(high_watermark=1, shed=True,
                                            retry_after_vt=1000.0)

    def engine(clock=None):
        return tiny_engine(clock=clock, **dict(over))

    router = make_fleet(n_replicas, seed=seed, engine=engine)
    reqs = make_workload(n_requests, min_len=8, max_len=64, seed=seed % 997)
    resps, fails = router.serve(reqs, traffic_class="sweep")
    assert_exactly_once(reqs, resps, fails)
    telem = router.telemetry()
    assert telem["requests"] == n_requests
    assert telem["served"] == sum(r is not None for r in resps)
    assert telem["shed"] + telem["failed"] == len(fails)
    if not tight:
        assert not fails


def test_routing_deterministic_given_seed():
    logs = []
    for _ in range(2):
        router = make_fleet(3, seed=1234)
        for chunk_seed in (5, 6):
            reqs = make_workload(10, min_len=8, max_len=64, seed=chunk_seed)
            resps, fails = router.serve(reqs, traffic_class="det")
            assert not fails
        logs.append(list(router.route_log))
    assert logs[0] == logs[1]
    assert len(logs[0]) == 20
    assert set(logs[0]) == {0, 1, 2}


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2 ** 16), st.integers(2, 4), st.integers(2, 10))
def test_snapshot_merge_equals_per_replica_fold(seed, n_replicas,
                                                n_requests):
    router = make_fleet(n_replicas, seed=seed)
    reqs = make_workload(n_requests, min_len=8, max_len=64, seed=seed % 991)
    resps, fails = router.serve(reqs)
    assert not fails
    per_replica = [rep.engine.telemetry_snapshot(source=rep.name)
                   for rep in router.replicas]
    manual = merge_snapshots(per_replica)
    fleet = router.snapshot()
    a, b = json.loads(fleet.to_json()), json.loads(manual.to_json())
    for d in (a, b):
        d.pop("captured_at")
        d.pop("gauges")
    assert a == b
    for key in manual.counters:
        assert manual.counters[key] == sum(
            s.counters.get(key, 0) for s in per_replica)
    assert manual.counters["sortserve_requests_total"] == n_requests


# ------------------------------------------------------- warm-start conformance
def _class_payload(eng, reqs, traffic_class) -> dict:
    sess = eng.begin(traffic_class=traffic_class)
    got = sess.feed(reqs, flush=True)
    got += sess.drain()
    telem = eng.telemetry()
    banks = telem["scheduler"]["banks"]
    by_id = {r.request_id: r for r in got}
    return {
        "responses": [
            {"backend": r.backend, "cycles": r.cycles,
             "column_reads": r.column_reads,
             "bucket_shape": list(r.bucket_shape),
             "values": _digest(r.values), "indices": _digest(r.indices)}
            for r in (by_id[req.request_id] for req in reqs)],
        "aggregate": {
            "column_reads": telem["column_reads"],
            "cycles_exact": telem["cycles_exact"],
            "tiles": telem["scheduler"]["tiles"],
            "bank_totals": [sum(b["busy_cycles"] for b in banks)],
        },
    }


@pytest.fixture(scope="module")
def port_artifact():
    """Warm state of a port replica that served the seed-21 workload under
    the ``gold`` traffic class."""
    donor = make_engine(clock=FakeClock())
    _class_payload(donor, make_workload(**SEED21), "gold")
    return save_warm_state(donor)


@pytest.fixture(scope="module")
def ref_artifact():
    """The same from a reference replica (a shorter workload: every jit
    signature compiles)."""
    donor = RefEngine(RefEngineConfig(**GOLDEN_CFG))
    sess = donor.begin(traffic_class="gold")
    sess.feed(make_workload(16, min_len=8, max_len=64, seed=21), flush=True)
    sess.drain()
    return ref_fleet.save_warm_state(donor)


def test_warm_restored_replica_serves_golden_byte_identical(port_artifact):
    ws = port_artifact
    payloads = []
    for warm in (False, True):
        request_mod._req_counter = itertools.count(10_000)
        eng = make_engine(clock=FakeClock())
        if warm:
            # a fresh replica process: the launcher cache is process-global
            EXECUTOR_CACHE.clear()
            stats = eng.apply_warm_state(load_warm_state(ws))
            assert stats["prewarmed"] > 0
            assert stats["classes"] == 1 and stats["signatures"] > 0
            assert eng.telemetry()["requests"] == 0
            assert sum(eng.policy._obs.values()) == sum(
                row["samples"] for row in ws["priors"])
            assert eng.telemetry()["executor_cache"]["prewarmed"] == \
                stats["prewarmed"]
        payloads.append(_class_payload(eng, make_workload(**SEED21), "gold"))
    cold, warm = (json.dumps(p, sort_keys=True) for p in payloads)
    assert cold == warm
    # and the flushed golden workload, byte for byte
    eng = make_engine()
    eng.apply_warm_state(load_warm_state(ws))
    assert golden_text(golden_payload(eng)).strip() == \
        GOLDEN.read_text().strip()


def test_warm_state_save_load_save_byte_stable(tmp_path, port_artifact):
    ws_path = tmp_path / "warm.json"
    restored = make_engine(clock=FakeClock())
    restored.apply_warm_state(load_warm_state(port_artifact))
    save_warm_state(restored, str(ws_path))
    first = ws_path.read_bytes()
    again = make_engine(clock=FakeClock())
    again.apply_warm_state(load_warm_state(str(ws_path)))
    save_warm_state(again, str(ws_path))
    assert ws_path.read_bytes() == first


def test_warm_state_rejects_bad_artifacts(tmp_path):
    good = save_warm_state(tiny_engine())
    assert good["format"] == "sortserve-warm-state"
    assert good["version"] == WARM_STATE_VERSION == 1
    bad = tmp_path / "corrupt.json"
    bad.write_text("{not json")
    with pytest.raises(WarmStateError):
        load_warm_state(str(bad))
    with pytest.raises(WarmStateError, match="version"):
        load_warm_state({**good, "version": WARM_STATE_VERSION + 1})
    with pytest.raises(WarmStateError, match="format"):
        load_warm_state({**good, "format": "something-else"})
    with pytest.raises(WarmStateError):
        load_warm_state({**good, "menus": {"cls": [["sort", 2]]}})
    with pytest.raises(WarmStateError):
        load_warm_state({**good, "priors": [{"backend": "numpy"}]})
    with pytest.raises(WarmStateError):
        load_warm_state({**good, "calibration": ["nope"]})
    with pytest.raises(WarmStateError):
        load_warm_state(str(tmp_path / "missing.json"))


def test_merge_warm_states_unions_and_weights():
    clock = FakeClock()
    engines = [make_engine(clock=clock, adaptive_policy=True)
               for _ in range(2)]
    for i, eng in enumerate(engines):
        _class_payload(eng, make_workload(12, min_len=8, max_len=64,
                                          seed=30 + i), f"cls{i}")
    per = [save_warm_state(e) for e in engines]
    merged = merge_warm_states(per)
    assert set(merged["menus"]) == {"cls0", "cls1"}
    assert len(merged["priors"]) >= max(len(p["priors"]) for p in per)
    by_key = {}
    for p in per:
        for row in p["priors"]:
            key = (row["backend"], row["op"], row["n"], row["k"],
                   row["traffic_class"])
            by_key.setdefault(key, []).append(row["s_per_row"])
    for row in merged["priors"]:
        key = (row["backend"], row["op"], row["n"], row["k"],
               row["traffic_class"])
        vals = by_key[key]
        assert min(vals) - 1e-12 <= row["s_per_row"] <= max(vals) + 1e-12
    assert load_warm_state(merged) is merged


# ----------------------------------------------- warm state across packages
def _canonical(ws: dict) -> str:
    return json.dumps(ws, sort_keys=True)


def test_reference_artifact_applies_in_port(ref_artifact, tmp_path):
    ref_eng = RefEngine(RefEngineConfig(**GOLDEN_CFG))
    want = ref_eng.apply_warm_state(ref_fleet.load_warm_state(ref_artifact))
    EXECUTOR_CACHE.clear()
    eng = make_engine()
    path = tmp_path / "ref.json"
    path.write_text(json.dumps(ref_artifact))
    got = eng.apply_warm_state(load_warm_state(str(path)))
    for key in ("classes", "signatures", "priors", "calibration"):
        assert got[key] == want[key], key
    assert got["prewarmed"] > 0 and got["signatures"] > 0
    # canonical re-save from the port: the reference's artifact, byte for byte
    assert _canonical(save_warm_state(eng)) == _canonical(ref_artifact)
    ref_fleet.save_warm_state(ref_eng, str(tmp_path / "a.json"))
    save_warm_state(eng, str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()


def test_port_artifact_loads_in_reference(port_artifact, tmp_path):
    path = tmp_path / "port.json"
    save_warm_state(make_engine(), str(path))      # a valid empty artifact
    assert ref_fleet.load_warm_state(str(path))["menus"] == {}
    loaded = ref_fleet.load_warm_state(json.loads(json.dumps(port_artifact)))
    ref_eng = RefEngine(RefEngineConfig(**GOLDEN_CFG))
    stats = ref_eng.apply_warm_state(loaded)
    assert stats["classes"] == 1
    assert stats["signatures"] == len(port_artifact["menus"]["gold"])
    assert stats["priors"] == len(port_artifact["priors"])
    assert _canonical(ref_fleet.save_warm_state(ref_eng)) == \
        _canonical(port_artifact)


# ------------------------------------------------------------------ failover
KILL_PLAN = FaultPlan(seed=3, dead_banks=(0, 1),
                      targets=frozenset({"numpy"}), enabled=False,
                      recovery=RecoveryPolicy(max_retries=0))


def _set_plan(router, index, enabled):
    inj = router.replicas[index].engine._injector
    inj.plan = dataclasses.replace(inj.plan, enabled=enabled)


def test_kill_mid_trace_fails_over_exactly_once_and_reinstates():
    clock = FakeClock()
    router = FleetRouter([tiny_engine(clock=clock),
                          tiny_engine(clock=clock, faults=KILL_PLAN)],
                         seed=9, clock=clock, error_threshold=2.0,
                         quarantine_s=10.0, probation_requests=2)
    reqs = make_workload(8, min_len=8, max_len=64, seed=40)
    resps, fails = router.serve(reqs, now=clock())
    assert not fails and set(router.route_log) == {0, 1}

    _set_plan(router, 1, True)                      # replica1 dies
    reqs = make_workload(8, min_len=8, max_len=64, seed=41)
    resps, fails = router.serve(reqs, now=clock())
    assert_exactly_once(reqs, resps, fails)
    assert not fails
    telem = router.telemetry()
    assert telem["failovers"] > 0
    assert telem["health"]["quarantines"] >= 1
    assert telem["per_replica"]["replica1"]["state"] == "quarantined"

    mark = len(router.route_log)
    reqs = make_workload(6, min_len=8, max_len=64, seed=42)
    resps, fails = router.serve(reqs, now=clock())
    assert not fails
    assert set(list(router.route_log)[mark:]) == {0}

    _set_plan(router, 1, False)                     # revived
    clock.tick(11.0)
    for chunk_seed in (43, 44, 45):
        reqs = make_workload(6, min_len=8, max_len=64, seed=chunk_seed)
        resps, fails = router.serve(reqs, now=clock())
        assert not fails
    telem = router.telemetry()
    assert telem["health"]["probations"] >= 1
    assert telem["health"]["reinstated"] >= 1
    assert telem["per_replica"]["replica1"]["state"] == "healthy"
    assert telem["per_replica"]["replica1"]["served"] > 0


@pytest.mark.parametrize("siblings", [1, 0])
def test_shed_redirects_to_sibling_or_surfaces_typed(siblings):
    tight = tiny_engine(admission=WatermarkPolicy(
        high_watermark=1, shed=True, retry_after_vt=1000.0))
    router = FleetRouter([tight] + [tiny_engine() for _ in range(siblings)],
                         seed=11)
    reqs = make_workload(16, min_len=32, max_len=32, seed=50)
    resps, fails = router.serve(reqs, traffic_class="burst")
    assert_exactly_once(reqs, resps, fails)
    telem = router.telemetry()
    if siblings:
        assert not fails
        assert telem["redirects"] > 0 and telem["shed"] == 0
        assert telem["per_replica"]["replica1"]["served"] > 0
    else:
        assert fails and telem["shed"] == len(fails)
        for _req, exc in fails:
            assert isinstance(exc, FleetSaturated)
            assert exc.retry_after_s > 0.0


def test_rolling_restart_under_load_zero_shed():
    clock = FakeClock()

    def build(clock=clock):
        return tiny_engine(clock=clock)

    router = FleetRouter([build(), build()], seed=13, clock=clock,
                         engine_factory=build)
    total = 0
    for step, chunk_seed in enumerate(range(60, 66)):
        reqs = make_workload(10, min_len=8, max_len=64, seed=chunk_seed)
        resps, fails = router.serve(reqs, traffic_class="live")
        assert not fails
        total += len(reqs)
        if step == 2:
            ws = router.save_warm_state()
            for index in range(2):
                stats = router.restart(index, warm_state=ws)
                assert stats["signatures"] > 0
    telem = router.telemetry()
    assert telem["served"] == total and telem["shed"] == 0
    assert telem["failed"] == 0
    assert telem["restarts"] == 2
    assert router.snapshot().counters["sortserve_requests_total"] == total


def test_launcher_fleet_smoke_on_cpu(tmp_path):
    from repro_torch.launch import sortserve
    ws = tmp_path / "warm.json"
    args = ["--smoke", "--device", "cpu", "--requests", "24", "--max_len",
            "128", "--sim_width_cap", "128", "--replicas", "2",
            "--rolling-restart", "--warm-state", str(ws)]
    assert sortserve.main(args) == 0
    first = load_warm_state(str(ws))
    assert first["priors"]
    assert sortserve.main(args) == 0              # reloads the artifact
    assert np.all([row["samples"] > 0 for row in
                   load_warm_state(str(ws))["priors"]])
