"""The stage readers' arithmetic: recorded snapshots whose telemetry
carries the program's stage table, the device trace's unspanned idle
share, and the front door's wait read from the tracer's chains."""

import numpy as np
import pytest

import _small  # noqa: F401  (puts the repository on sys.path)
from perfbench.metrics import _lib
from test_perfbench_metrics import CONFIGS, context, read, snapshot, window


def stage_snapshot(t, stages, tiles, radix_tiles=0, mesh_tiles=0):
    """A recorded snapshot whose telemetry carries the program's stage
    table: ``stages`` maps a name to ``(n, s, self_s)``."""
    snap = snapshot(t, tiles, 0.0, 0, 0, 0, 0, mesh_tiles=mesh_tiles)
    tel = snap["telemetry"]
    tel["per_backend"]["radix_topk"] = {"tiles": radix_tiles, "wall_s": 0.0}
    tel["stages"] = {name: {"n": n, "s": s, "self_s": own}
                     for name, (n, s, own) in stages.items()}
    return snap


def stage_context(trace=None, tracer=None, window=None):
    # a recorded window of 2.0 s: 100 colskip and 20 mesh tiles, 40 radix
    # tiles; each stage's growth is its close entry less its open entry
    opened = {"sortserve.bucket": (10, 0.010, 0.010),
              "sortserve.emit": (10, 0.002, 0.002),
              "sortserve.schedule": (10, 0.500, 0.030),
              "sortserve.execute": (50, 0.400, 0.020),
              "sortserve.scatter": (50, 0.050, 0.050),
              "colskip.h2d": (50, 0.005, 0.005),
              "colskip.launch": (50, 0.010, 0.010),
              "colskip.d2h": (50, 0.300, 0.300),
              "radix_topk.h2d": (4, 0.001, 0.001),
              "radix_topk.launch": (4, 0.002, 0.002),
              "radix_topk.d2h": (4, 0.003, 0.003),
              "frontdoor.collect": (30, 0.300, 0.010)}
    grown = {"sortserve.bucket": (20, 0.030, 0.028),
             "sortserve.emit": (20, 0.006, 0.006),
             "sortserve.schedule": (20, 0.900, 0.048),
             "sortserve.execute": (120, 0.600, 0.036),
             "sortserve.scatter": (120, 0.072, 0.072),
             "colskip.h2d": (100, 0.012, 0.012),
             "colskip.launch": (100, 0.024, 0.024),
             "colskip.d2h": (100, 0.096, 0.096),
             "colskip_mesh.h2d": (30, 0.006, 0.006),
             "colskip_mesh.launch": (20, 0.012, 0.012),
             "colskip_mesh.d2h": (20, 0.060, 0.060),
             "radix_topk.h2d": (40, 0.004, 0.004),
             "radix_topk.launch": (40, 0.008, 0.008),
             "radix_topk.d2h": (40, 0.012, 0.012),
             "frontdoor.collect": (900, 1.500, 0.100)}
    closed = {k: tuple(a + b for a, b in zip(opened.get(k, (0, 0, 0)), g))
              for k, g in grown.items()}
    marks = {"open": stage_snapshot(10.0, opened, 5, 10),
             "close": stage_snapshot(12.0, closed, 105, 50, mesh_tiles=20)}
    return _lib.Context(window=window or {}, marks=marks,
                        config=CONFIGS["colskip-n1024-w32-k2"], mix={},
                        seconds=2.0, setup_s=7.5, trace=trace, tracer=tracer)


def test_stage_readers():
    ctx = stage_context()
    tiles = 100 + 20 + 40                   # every backend's tiles
    assert read("bucket_ms_per_tile.backlog", ctx) == \
        pytest.approx((0.028 + 0.006) / tiles * 1e3)
    assert read("schedule_ms_per_tile.backlog", ctx) == \
        pytest.approx(0.048 / tiles * 1e3)
    assert read("account_ms_per_tile.backlog", ctx) == \
        pytest.approx(0.036 / tiles * 1e3)
    assert read("scatter_ms_per_tile.backlog", ctx) == \
        pytest.approx(0.072 / tiles * 1e3)
    # the machine stages over the machine tiles alone, with their spans'
    # whole time (the mesh's prefetch copies in h2d)
    assert read("h2d_ms_per_tile.backlog", ctx) == \
        pytest.approx((0.012 + 0.006) / 120 * 1e3)
    assert read("launch_ms_per_tile.backlog", ctx) == \
        pytest.approx((0.024 + 0.012) / 120 * 1e3)
    assert read("d2h_ms_per_tile.backlog", ctx) == \
        pytest.approx((0.096 + 0.060) / 120 * 1e3)
    assert read("radix_host_ms_per_tile.poisson", ctx) == \
        pytest.approx((0.004 + 0.008 + 0.012) / 40 * 1e3)
    assert read("collector_busy_pct.poisson", ctx) == \
        pytest.approx(100 * 1.5 / 2.0)


@pytest.mark.parametrize("name", [
    "bucket_ms_per_tile.backlog", "schedule_ms_per_tile.backlog",
    "account_ms_per_tile.backlog", "scatter_ms_per_tile.backlog",
    "h2d_ms_per_tile.backlog", "launch_ms_per_tile.backlog",
    "d2h_ms_per_tile.backlog", "radix_host_ms_per_tile.poisson",
    "collector_busy_pct.poisson"])
def test_stage_readers_give_nothing_without_a_stage_table(name):
    """A program that keeps no stage table (the recorded snapshots of
    the other tests) gives no number, and raises nothing."""
    assert read(name, context()) is None


def test_unspanned_idle_share():
    gaps = [["aten::empty_strided", 1.5], ["host python in feed", 0.5],
            ["sortserve.bucket", 2.0]]
    trace = {"busy_s": 1.0, "window_s": 6.0, "kernels": {},
             "idle_gaps": gaps}
    assert read("idle_unspanned_pct.backlog",
                context(trace=trace)) == pytest.approx(100 * 0.5 / 5.0)
    # below the listed entries: 0
    trace["idle_gaps"] = gaps[:1] + gaps[2:]
    assert read("idle_unspanned_pct.backlog", context(trace=trace)) == 0.0
    assert read("idle_unspanned_pct.backlog", context()) is None


def test_frontdoor_wait_reader():
    w = window(np.ones(40), np.zeros(40))
    # request i waited i / 10 ms in the queue; a chain of a request
    # outside the window, and one with no ingest stamp, are left out
    chains = [{"rid": i, "t_feed": 1.0, "t_ingest": 1.0 + i * 1e-4}
              for i in range(40)]
    chains += [{"rid": 99, "t_feed": 0.0, "t_ingest": 5.0},
               {"rid": 3, "t_feed": 0.0}]
    tracer = type("Recorded", (), {"chains": chains})
    ctx = stage_context(tracer=tracer, window=w)
    assert read("frontdoor_wait_p95_ms.poisson", ctx) == \
        pytest.approx(np.percentile(np.arange(40) / 10, 95))
    assert read("frontdoor_wait_p95_ms.poisson", stage_context()) is None
    # chains of a program that stamps no ingest: nothing to read
    tracer.chains = [{"rid": 1, "t_feed": 1.0}]
    assert read("frontdoor_wait_p95_ms.poisson", ctx) is None
