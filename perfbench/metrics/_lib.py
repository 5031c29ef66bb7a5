"""What the metric readers share: the run's context and the reading of the
profiler's trace.

A reader is ``metrics/<name>.py`` with ``read(ctx) -> float | None``
(None: nothing to read in this run, and the metric is left out of the
line) and, optionally, ``NEEDS``: ``{"tracer"}`` asks the harness to run
the program's request tracer in the traced run.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

TOP = 10                # entries of each breakdown list
NAME_CHARS = 120        # a kernel's name is cut to this in the breakdown


@dataclass
class Context:
    window: dict                 # the generator's drive() record
    marks: dict                  # engine snapshots at the window's open/close
    config: dict
    mix: dict
    seconds: float
    setup_s: float
    trace: dict | None           # read_trace() of a traced run
    tracer: object | None        # the program's request tracer, if it ran
    expected_reads: dict = field(default_factory=dict)  # index -> CRs

    # -------------------------------------------------------- engine counters
    def delta(self, *path) -> float:
        """A telemetry counter's growth over the window."""
        def at(snap):
            v = snap["telemetry"]
            for p in path:
                v = v.get(p, {}) if isinstance(v, dict) else 0
            return v if isinstance(v, (int, float)) else 0
        return at(self.marks["close"]) - at(self.marks["open"])

    def batcher_delta(self, key: str) -> int:
        return (self.marks["close"]["batcher"][key]
                - self.marks["open"]["batcher"][key])

    def backend_tiles(self, name: str) -> float:
        return self.delta("per_backend", name, "tiles")

    def backend_wall(self, name: str) -> float:
        return self.delta("per_backend", name, "wall_s")

    def loop_s(self) -> float:
        """Host seconds from the window's open to its close."""
        return self.marks["close"]["t"] - self.marks["open"]["t"]

    # ------------------------------------------------------------- requests
    def in_loop(self) -> np.ndarray:
        """Indices of requests answered before the window closed."""
        t_done = self.window["t_done"]
        return np.flatnonzero(np.isfinite(t_done)
                              & (t_done <= self.window["t_loop"]))

    def kernel_s(self, *names: str) -> float | None:
        """Device seconds of the traced kernels whose name holds one of
        ``names``; None without a trace or with no such kernel."""
        if self.trace is None:
            return None
        total = sum(s for k, s in self.trace["kernels"].items()
                    if any(n in k for n in names))
        return total if total > 0 else None


def percentile(values, q: float) -> float | None:
    values = np.asarray(values, float)
    if values.size == 0:
        return None
    return float(np.percentile(values, q))


HARNESS_SPANS = ("window", "feed", "submit")


def read_trace(prof) -> dict:
    """Device busy time, kernel time by name and idle gaps by what the host
    was doing, inside the harness's ``window`` span of a profiled run."""
    from torch.autograd import DeviceType
    dev, host, win = [], [], None
    for e in prof.profiler.kineto_results.events():
        start, end = e.start_ns(), e.end_ns()
        if e.device_type() != DeviceType.CUDA:
            host.append((start, end, e.name()))
            if e.name() == "window":
                win = (start, end)
        elif not (e.is_user_annotation() or e.name() in HARNESS_SPANS):
            dev.append((start, end, e.name()))      # not a span's copy
    if win is None:
        raise RuntimeError("the trace holds no 'window' span")
    w0, w1 = win
    by_name: dict[str, float] = {}
    spans = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
            spans.append((s, e))
    spans.sort()
    busy, gaps, cur = 0, [], w0
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if cur < w1:
        gaps.append((cur, w1))
    idle = _label_gaps(gaps, host)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    spans_s = {n: sum(min(e, w1) - max(s, w0) for s, e, m in host
                      if m == n and min(e, w1) > max(s, w0)) / 1e9
               for n in HARNESS_SPANS}
    return {
        "spans_s": spans_s,
        "busy_s": busy / 1e9,
        "window_s": (w1 - w0) / 1e9,
        "kernels": by_name,
        "device_ops": [[n[:NAME_CHARS], s] for n, s in top],
        "idle_gaps": sorted(idle.items(), key=lambda kv: -kv[1])[:TOP],
    }


GAP_STEP_NS = 50_000     # idle time is attributed in slices of this length


def _label_gaps(gaps, host) -> dict:
    """Idle seconds by what the host was doing: each gap is cut into
    slices of :data:`GAP_STEP_NS`, and each slice goes to the innermost
    host event covering its middle (the latest-started one still
    running); a harness span means the host was in Python inside that
    call, outside any torch operation."""
    host = sorted(host)
    points = []
    for a, b in gaps:
        n = max(1, int((b - a) // GAP_STEP_NS))
        step = (b - a) / n
        points += [(a + (i + 0.5) * step, step) for i in range(n)]
    points.sort()
    out: dict[str, float] = {}
    live: list = []                 # (-start, end, name)
    j = 0
    for at, length in points:
        while j < len(host) and host[j][0] <= at:
            heapq.heappush(live, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while live and live[0][1] < at:
            heapq.heappop(live)
        if live:
            name = live[0][2]
            if name in HARNESS_SPANS:
                name = f"host python in {name}"
        else:
            name = "no host event"
        out[name] = out.get(name, 0.0) + length / 1e9
    return out


def machine_work(ctx: Context, backend: str,
                 mesh: bool) -> tuple[int, int] | None:
    """``(word operations, bytes)`` the reference counts for the rows that
    ``backend`` served before the window closed; None when it served none
    or the reference did not count a row."""
    from perfbench.reference.sortref import pow2_width

    from ._roofline import colskip_row_work
    ops = nbytes = 0
    for i in ctx.in_loop():
        req, resp = ctx.window["requests"][i], ctx.window["responses"][i]
        if resp.backend != backend:
            continue
        reads = ctx.expected_reads.get(int(i))
        if reads is None:
            return None
        width = pow2_width(req.n, ctx.config["min_bucket"])
        out = pow2_width(req.k, 1) if req.op == "kmin" else width
        o, b = colskip_row_work(width, reads, out, mesh)
        ops += o
        nbytes += b
    return (ops, nbytes) if ops else None


def machine_roofline(ctx: Context, backend: str, kernels: tuple,
                     mesh: bool) -> float | None:
    """Share of the roofline of the column-skipping kernels that served
    ``backend``'s rows in the traced window: the least time for the work
    the reference counts over the kernels' device time."""
    from ._roofline import least_time_s, share_pct
    work = machine_work(ctx, backend, mesh)
    if work is None:
        return None
    return share_pct(least_time_s(*work), ctx.kernel_s(*kernels))
