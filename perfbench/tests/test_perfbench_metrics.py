"""The metric readers' arithmetic on recorded telemetry, and the work
count behind the rooflines."""

import json

import numpy as np
import pytest

from _small import REPO
from perfbench import harness
from perfbench.metrics import _lib, _roofline
from perfbench.reference import sortref
from perfbench.traffic import closed_loop
from perfbench.traffic.records import Req, Resp

CONFIGS = {name: json.loads(
    (REPO / f"perfbench/configs/{name}.json").read_text())
    for name in ("colskip-n1024-w32-k2", "colskip-mesh-d4-n1024-w32-k2")}


def snapshot(t, tiles, wall, requests, pad, real, rounds, mesh_tiles=0,
             mesh_wall=0.0):
    return {"telemetry": {"per_backend": {
                "colskip": {"tiles": tiles, "wall_s": wall},
                "colskip_mesh": {"tiles": mesh_tiles, "wall_s": mesh_wall}},
                          "cache": {"hits": 0}},
            "batcher": {"tiles": tiles + mesh_tiles, "requests": requests,
                        "pad_cols": pad, "real_elems": real},
            "mesh_rounds": rounds, "t": t}


def context(window=None, trace=None, config="colskip-n1024-w32-k2",
            expected=None):
    # a recorded window: 100 colskip tiles of 1.2 ms in 2.0 s, and
    # 10 mesh tiles of 3 ms making 45,000 rounds
    marks = {"open": snapshot(10.0, 5, 0.006, 40, 100, 900, 1000),
             "close": snapshot(12.0, 105, 0.126, 440, 1100, 9900, 46000,
                               mesh_tiles=10, mesh_wall=0.03)}
    return _lib.Context(window=window or {}, marks=marks,
                        config=CONFIGS[config], mix={},
                        seconds=2.0, setup_s=7.5, trace=trace, tracer=None,
                        expected_reads=expected or {})


def read(name, ctx):
    return harness.metric_reader(REPO, name).read(ctx)


def test_telemetry_readers():
    ctx = context()
    assert read("tile_ms.colskip", ctx) == pytest.approx(1.2)
    assert read("tile_ms.colskip_mesh", ctx) == pytest.approx(3.0)
    assert read("mesh_rounds_per_tile", ctx) == pytest.approx(4500.0)
    # (2.0 s - 0.12 s - 0.03 s) over 110 tiles
    assert read("engine_host_ms_per_tile.backlog", ctx) == \
        pytest.approx(1.85 / 110 * 1e3)
    assert read("tile_fill_pct.poisson", ctx) == pytest.approx(
        100 * 400 / (110 * 8))
    assert read("pad_col_pct.poisson", ctx) == pytest.approx(
        100 * 1000 / (1000 + 9000))
    assert read("setup_s", ctx) == 7.5


def window(lat_ms, late_ms, n=100):
    k = len(lat_ms)
    due = np.arange(k) * 0.01
    return {"requests": [Req("sort", np.zeros(n, np.uint32), None, n, i)
                         for i in range(k)],
            "responses": [Resp("colskip", None, None, 1, 1)] * k,
            "t_due": due, "t_submit": due + np.asarray(late_ms) / 1e3,
            "t_done": due + np.asarray(lat_ms) / 1e3, "t0": 0.0,
            "t_end": 2.0, "t_loop": 2.0}


def test_latency_readers():
    lat = np.arange(1, 101, dtype=float)          # 1 .. 100 ms
    w = window(lat, lat / 10)
    ctx = context(window=w)
    assert read("latency_p95_ms.poisson", ctx) == \
        pytest.approx(np.percentile(lat, 95))
    assert read("gen_late_p99_ms.poisson", ctx) == \
        pytest.approx(np.percentile(lat / 10, 99))
    # answered by 2.0 s: the first 100 requests' responses all arrive by
    # 0.99 + 0.1 s, each of 100 keys, over the window's 2 s
    assert read("elems_per_s", ctx) == pytest.approx(100 * 100 / 2.0)
    # a request that never came is beyond any limit
    w["responses"] = [None] * 10 + w["responses"][10:]
    assert read("latency_p95_ms.poisson", ctx) is None


def test_idle_share_and_gap_labels():
    trace = {"busy_s": 0.5, "window_s": 2.0, "kernels": {}}
    assert read("device_idle_pct.backlog", context(trace=trace)) == 75.0
    host = [(0, 100_000, "window"), (10_000, 60_000, "feed"),
            (12_000, 15_000, "aten::copy_")]
    idle = _lib._label_gaps([(12_000, 14_000), (20_000, 40_000),
                             (70_000, 90_000)], host)
    assert idle == pytest.approx({"aten::copy_": 2e-6,
                                  "host python in feed": 20e-6,
                                  "host python in window": 20e-6})


def test_roofline_arithmetic():
    ops, nbytes = _roofline.colskip_row_work(1024, 27_000, 1024)
    assert ops == 27_000 * 32
    assert nbytes == 4 * 1024 + 8 * 1024 + 8
    assert _roofline.least_time_s(ops, nbytes) == pytest.approx(
        ops / (132 * 64 * 1.98e9))
    assert _roofline.share_pct(1e-6, 1e-3) == pytest.approx(0.1)
    assert _roofline.share_pct(1e-6, None) is None
    # a radix launch at (8, 4096), k = 32: keys in, 2k + 1 words a row out
    assert _roofline.radix_tile_bytes(8, 4096, 32) == 4 * 8 * 4096 + \
        4 * 8 * 65


def test_same_work_on_one_bank_and_on_the_mesh():
    """The same seeded inputs need the same column reads whatever machine
    serves them, so the least time reads the same for both
    configurations."""
    mix = json.loads(
        (REPO / "perfbench/traffic/uniform1024.backlog.json").read_text())
    least = {}
    for name, backend in (("colskip-n1024-w32-k2", "colskip"),
                          ("colskip-mesh-d4-n1024-w32-k2", "colskip_mesh")):
        config = CONFIGS[name]
        plan = closed_loop.prepare(dict(mix, pool=4), config, 2**33 + 5, 1)
        reqs = [Req(plan["ops"][i], closed_loop._payload(plan, i), None,
                    1024, i) for i in range(16)]
        expected = {i: sortref.colskip_reads(r.payload)[0]
                    for i, r in enumerate(reqs)}
        w = {"requests": reqs,
             "responses": [Resp(backend, None, None, 0, 0)] * 16,
             "t_done": np.zeros(16), "t_loop": 1.0}
        ctx = context(window=w, config=name, expected=expected)
        ops, nbytes = _lib.machine_work(ctx, backend,
                                        mesh=backend == "colskip_mesh")
        least[name] = _roofline.least_time_s(ops, nbytes)
    a, b = least.values()
    assert a == b > 0
