"""Windowed metrics primitives: counter / gauge / log-bucket histogram.

The engine's original telemetry is all-time aggregate — fine for a batch
run, useless as a *placement signal* for a fleet router that needs to know
what a replica did in the last minute, not since boot.  This module
provides the sliding-window primitives the engine's ``telemetry()["window"]``
section is built from:

  * :class:`WindowedCounter` — timestamped increments; ``total(now)`` is the
    sum inside the window, ``all_time`` the running total;
  * :class:`Gauge` — last-written value (queue depth, occupancy);
  * :class:`LogBucketHistogram` — all-time log2 buckets (bounded memory for
    any stream length) plus a bounded timestamped sample window for *exact*
    recent quantiles (p50/p99 of the last ``maxlen`` samples inside
    ``window_s``);
  * :class:`MetricsRegistry` — the engine-facing composition: request /
    tile / shed counters, latency histogram, occupancy samples, and the
    ``window()`` dict exported into telemetry.

Every method takes an explicit ``now`` (the engine's injectable clock), so
windowed behaviour is deterministic under a fake clock — no ``time.time()``
anywhere.  ``snapshot()`` / ``restore()`` give the engine's all-or-nothing
submit rollback the same coverage it has for every other counter.
"""

from __future__ import annotations

import math
from collections import deque

__all__ = ["Gauge", "LogBucketHistogram", "MetricsRegistry",
           "WindowedCounter"]


class WindowedCounter:
    """Monotone counter with a sliding-window view.

    Increments are timestamped; ``total(now)`` sums the increments inside
    ``(now - window_s, now]`` (older entries are pruned lazily, so memory is
    bounded by the event rate times the window, capped at ``maxlen``).
    """

    def __init__(self, window_s: float, maxlen: int = 65536):
        self.window_s = float(window_s)
        self._events: deque = deque(maxlen=maxlen)   # (t, amount)
        self.all_time = 0
        self.first_t: float | None = None

    def add(self, now: float, amount: int = 1) -> None:
        self.all_time += amount
        if self.first_t is None:
            self.first_t = now
        self._events.append((now, amount))

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def total(self, now: float) -> int:
        self._prune(now)
        return sum(a for _, a in self._events)

    def rate(self, now: float) -> float:
        """Events/s over the *effective* window: the full ``window_s`` once
        the stream is older than the window, the stream's age before that
        (so a young stream is not reported as mysteriously slow)."""
        if self.first_t is None:
            return 0.0
        span = max(min(self.window_s, now - self.first_t), 1e-9)
        return self.total(now) / span

    def snapshot(self) -> tuple:
        return (list(self._events), self.all_time, self.first_t)

    def restore(self, snap: tuple) -> None:
        events, all_time, first_t = snap
        self._events = deque(events, maxlen=self._events.maxlen)
        self.all_time = all_time
        self.first_t = first_t


class Gauge:
    """Last-written value (point-in-time signals: queue depth, inflight).

    Writes are timestamped (``set(now, value)``) so that two gauges from
    different engine snapshots merge **last-writer-wins deterministically**:
    the aggregation layer orders by ``(t, value)`` — the value tie-break
    makes the merge associative even when two engines wrote at the same
    clock instant (fake clocks do that all the time)."""

    def __init__(self, value: float = 0.0, t: float = float("-inf")):
        self.value = float(value)
        self.t = float(t)

    def set(self, now: float, value: float) -> None:
        self.t = float(now)
        self.value = float(value)

    def merge_key(self) -> tuple[float, float]:
        """Total order for last-writer-wins merging."""
        return (self.t, self.value)

    def snapshot(self) -> tuple[float, float]:
        return (self.t, self.value)

    def restore(self, snap: tuple[float, float]) -> None:
        self.t, self.value = snap


class LogBucketHistogram:
    """Log2-bucketed all-time histogram + exact windowed quantiles.

    The all-time view is O(#buckets) memory for any stream length: a value
    lands in bucket ``ceil(log2(value / lo))`` (values below ``lo`` share
    bucket 0).  The windowed view keeps the last ``maxlen`` timestamped raw
    samples, so recent p50/p99 are exact, not bucket-quantized.
    """

    def __init__(self, window_s: float, maxlen: int = 4096, lo: float = 1e-7):
        if lo <= 0:
            raise ValueError("lo must be positive")
        self.window_s = float(window_s)
        self.lo = float(lo)
        self.buckets: dict[int, int] = {}    # all-time log2 buckets
        self.all_time_count = 0
        self.all_time_sum = 0.0
        self._samples: deque = deque(maxlen=maxlen)   # (t, value)

    def observe(self, now: float, value: float) -> None:
        value = float(value)
        b = 0 if value <= self.lo else int(
            math.ceil(math.log2(value / self.lo)))
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.all_time_count += 1
        self.all_time_sum += value
        self._samples.append((now, value))

    def bucket_bounds(self, b: int) -> tuple[float, float]:
        """(low, high] value range of bucket ``b``."""
        if b == 0:
            return (0.0, self.lo)
        return (self.lo * 2.0 ** (b - 1), self.lo * 2.0 ** b)

    def _window_values(self, now: float) -> list[float]:
        horizon = now - self.window_s
        return [v for t, v in self._samples if t >= horizon]

    def count(self, now: float) -> int:
        return len(self._window_values(now))

    def mean(self, now: float) -> float:
        vals = self._window_values(now)
        return sum(vals) / len(vals) if vals else 0.0

    def percentile(self, now: float, q: float) -> float:
        """Exact q-th percentile (nearest-rank) of in-window samples."""
        vals = sorted(self._window_values(now))
        if not vals:
            return 0.0
        rank = min(len(vals) - 1, max(0, math.ceil(q / 100.0 * len(vals)) - 1))
        return vals[rank]

    def snapshot(self) -> tuple:
        return (dict(self.buckets), self.all_time_count, self.all_time_sum,
                list(self._samples))

    def restore(self, snap: tuple) -> None:
        buckets, count, total, samples = snap
        self.buckets = dict(buckets)
        self.all_time_count = count
        self.all_time_sum = total
        self._samples = deque(samples, maxlen=self._samples.maxlen)


class MetricsRegistry:
    """The engine's windowed-signal bundle behind ``telemetry()["window"]``.

    Hooks (all under the engine lock, all with the engine's clock):
    ``request_done`` at every delivered response, ``request_rejected`` at
    every shed/failed request, ``tile_executed`` at every backend execution
    (with the pool's instantaneous occupancy).  ``window(now, queue_depth)``
    renders the fixed-key dict the telemetry doc pins.
    """

    def __init__(self, window_s: float = 60.0, maxlen: int = 4096):
        self.window_s = float(window_s)
        self.requests = WindowedCounter(window_s)
        self.tiles = WindowedCounter(window_s)
        self.shed = WindowedCounter(window_s)
        self.failed = WindowedCounter(window_s)
        self.latency = LogBucketHistogram(window_s, maxlen=maxlen)
        self.occupancy = LogBucketHistogram(window_s, maxlen=maxlen, lo=1e-4)
        # timestamped point-in-time signals; last-writer-wins on merge
        self.queue_depth_g = Gauge()
        self.occupancy_g = Gauge()

    def request_done(self, now: float, latency_s: float) -> None:
        self.requests.add(now)
        self.latency.observe(now, latency_s)

    def request_rejected(self, now: float, shed: bool) -> None:
        (self.shed if shed else self.failed).add(now)

    def tile_executed(self, now: float, occupancy: float) -> None:
        self.tiles.add(now)
        self.occupancy.observe(now, occupancy)
        self.occupancy_g.set(now, occupancy)

    def window(self, now: float, queue_depth: int) -> dict:
        """The live placement signal: recent counts, rates, latency
        quantiles, occupancy, and shed rate over the sliding window."""
        n_req = self.requests.total(now)
        n_shed = self.shed.total(now)
        self.queue_depth_g.set(now, queue_depth)
        return {
            "window_s": self.window_s,
            "requests": n_req,
            "tiles": self.tiles.total(now),
            "shed": n_shed,
            "failed": self.failed.total(now),
            "requests_per_s": self.requests.rate(now),
            "tiles_per_s": self.tiles.rate(now),
            "latency_s": {
                "mean": self.latency.mean(now),
                "p50": self.latency.percentile(now, 50),
                "p99": self.latency.percentile(now, 99),
            },
            "queue_depth": int(queue_depth),
            "occupancy": self.occupancy.mean(now),
            "shed_rate": n_shed / max(1, n_req + n_shed),
        }

    def snapshot(self) -> dict:
        return {name: getattr(self, name).snapshot()
                for name in ("requests", "tiles", "shed", "failed",
                             "latency", "occupancy",
                             "queue_depth_g", "occupancy_g")}

    def restore(self, snap: dict) -> None:
        for name, sub in snap.items():
            getattr(self, name).restore(sub)
