"""OpenMetrics / Prometheus text exposition of the telemetry tree.

The fleet tier needs telemetry *outside* the process, in the format every
scraper already speaks.  :func:`render_openmetrics` turns a
:class:`~repro_torch.obs.aggregate.TelemetrySnapshot` (single engine or merged
fleet) into the text exposition format:

  * counters end in ``_total`` with labels for backend / width / op /
    traffic_class / bank (``sortserve_backend_tiles_total{backend="colskip"}``);
  * gauges carry their engine-clock timestamp as the optional exposition
    timestamp, so a scrape of a merged fleet view shows *when* each
    last-writer-wins value was written;
  * every :class:`~repro_torch.obs.metrics.LogBucketHistogram` exports as a
    native cumulative histogram: log2 bucket ``b`` maps to
    ``le="lo * 2^b"``, closed with ``le="+Inf"`` plus ``_sum``/``_count``;
  * calibration cells export as per-(backend, width) counters plus a
    pooled ``ratio`` gauge; SLO state exports as burn-rate gauges, an
    ``alerting`` 0/1 gauge, and an ``alerts_total`` counter per
    (traffic_class, SLI).

Rendering works from the snapshot's raw accumulators, not from
``telemetry()``'s rendered dict — no percentile sorts, no deep copies —
which is what keeps the export-overhead benchmark row
(``benchmarks/streaming_bench.py``) inside its <= 5% gate.

:func:`parse_exposition` is the inverse used by the round-trip tests (and
by ``scripts/bench_diff.py``-style tooling): it validates the line
grammar, the cumulative monotonicity of histogram buckets, and the
``# EOF`` terminator, and returns the sample values by series.

Entry points: ``engine.dump_metrics(path)``, the ``AsyncSortServe
.metrics()`` pull endpoint, and ``launch.sortserve --metrics-out``.
"""

from __future__ import annotations

import re

from repro_torch.obs.aggregate import (PREFIX, TelemetrySnapshot, _escape,
                                 evaluate_slo, series, split_series)

__all__ = ["parse_exposition", "render_openmetrics", "write_metrics"]


def _fmt(value) -> str:
    """Canonical sample formatting: integers stay integers, floats use
    repr (shortest round-trippable form) — deterministic either way."""
    if type(value) is int:                       # hot path: counters
        return str(value)
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    f = float(value)
    if f != f:                                   # NaN never leaves
        return "0"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# series ids repeat scrape over scrape (bounded by banks/backends/ops),
# so the sid -> family map is memoized module-wide; this is on the
# export-overhead gate's hot path (benchmarks/streaming_bench)
_FAMILY_CACHE: dict = {}


def _family(sid: str) -> str:
    fam = _FAMILY_CACHE.get(sid)
    if fam is None:
        name = sid.partition("{")[0]
        fam = name[:-len("_total")] if name.endswith("_total") else name
        if len(_FAMILY_CACHE) < 4096:
            _FAMILY_CACHE[sid] = fam
    return fam


def _inner(labels: dict) -> str:
    """Rendered label block (``{k="v",...}`` sorted), "" when unlabeled."""
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"'
                          for k, v in sorted(labels.items())) + "}"


def render_openmetrics(snap: TelemetrySnapshot,
                       now: float | None = None) -> str:
    """Render a snapshot as OpenMetrics text (ends with ``# EOF``)."""
    now = snap.captured_at if now is None else now
    lines: list[str] = []
    append = lines.append
    seen_types: set[str] = set()

    def typ(family: str, kind: str) -> None:
        if family not in seen_types:
            seen_types.add(family)
            append(f"# TYPE {family} {kind}")

    def sample(sid: str, value, ts: float | None = None) -> None:
        stamp = "" if ts is None else f" {_fmt(float(ts))}"
        append(f"{sid} {_fmt(value)}{stamp}")

    # counters — the bulk of the exposition; inlined formatting keeps one
    # scrape inside the export-overhead gate (benchmarks/streaming_bench)
    counters = snap.counters
    for sid in sorted(counters):
        fam = _family(sid)
        if fam not in seen_types:
            seen_types.add(fam)
            append(f"# TYPE {fam} counter")
        v = counters[sid]
        append(f"{sid} {v}" if type(v) is int else f"{sid} {_fmt(v)}")

    # calibration: pooled per-(backend, width) counters + ratio gauge
    cal = sorted(snap.calibration.items())
    typ(PREFIX + "calibration_tiles", "counter")
    typ(PREFIX + "calibration_wall_seconds", "counter")
    typ(PREFIX + "calibration_modeled_cycles", "counter")
    for key, (tiles, wall, cyc) in cal:
        backend, _, width = key.partition("|")
        lbl = f'{{backend="{_escape(backend)}",width="{_escape(width)}"}}'
        append(f"{PREFIX}calibration_tiles_total{lbl} {_fmt(tiles)}")
        append(f"{PREFIX}calibration_wall_seconds_total{lbl} {_fmt(wall)}")
        append(f"{PREFIX}calibration_modeled_cycles_total{lbl} {_fmt(cyc)}")
    typ(PREFIX + "calibration_ratio", "gauge")
    for key, (tiles, wall, cyc) in cal:
        backend, _, width = key.partition("|")
        modeled_s = cyc / snap.clock_hz if snap.clock_hz > 0 else 0.0
        lbl = f'{{backend="{_escape(backend)}",width="{_escape(width)}"}}'
        ratio = wall / modeled_s if modeled_s > 0 else 0.0
        append(f"{PREFIX}calibration_ratio{lbl} {_fmt(ratio)}")

    for sid in sorted(snap.gauges):
        t, value = snap.gauges[sid]
        typ(_family(sid), "gauge")
        sample(sid, value, ts=None if t == float("-inf") else t)
    for sid in sorted(snap.maxima):
        typ(_family(sid), "gauge")
        sample(sid, snap.maxima[sid])

    # windowed counters: in-window totals and rates as gauges
    for sid in sorted(snap.windows):
        w = snap.windows[sid]
        name, labels = split_series(sid)
        lbl = _inner(labels)
        horizon = now - w["window_s"]
        total = sum(a for t, a in w["events"] if t > horizon)
        typ(name + "_recent", "gauge")
        append(f"{name}_recent{lbl} {_fmt(total)}")
        first_t = w.get("first_t")
        if first_t is not None:
            span = max(min(w["window_s"], now - first_t), 1e-9)
            typ(name + "_per_second", "gauge")
            append(f"{name}_per_second{lbl} {_fmt(total / span)}")

    for sid in sorted(snap.histograms):
        hist = snap.histograms[sid]
        name, labels = split_series(sid)
        lbl = _inner(labels)
        # bucket series get the extra le label appended to the others
        pre = (f"{name}_bucket{{{lbl[1:-1]}," if lbl
               else f"{name}_bucket{{")
        typ(name, "histogram")
        cum = 0
        buckets = hist["buckets"]
        for b in sorted(int(k) for k in buckets):
            cum += buckets[str(b)]
            le = hist["lo"] if b == 0 else hist["lo"] * 2.0 ** b
            append(f'{pre}le="{_fmt(le)}"}} {cum}')
        append(f'{pre}le="+Inf"}} {_fmt(hist["count"])}')
        append(f'{name}_count{lbl} {_fmt(hist["count"])}')
        append(f'{name}_sum{lbl} {_fmt(hist["sum"])}')

    # SLO: burn rates re-evaluated over the snapshot's events at `now`
    slo = evaluate_slo(snap.slo, now)
    for cls, per in sorted(slo.items()):
        for sli, st in sorted(per.items()):
            # label order matches series(): sli < traffic_class < window
            lbl = (f'sli="{_escape(sli)}",'
                   f'traffic_class="{_escape(cls)}"')
            typ(PREFIX + "slo_good", "counter")
            append(f'{PREFIX}slo_good_total{{{lbl}}} {st["good"]}')
            typ(PREFIX + "slo_bad", "counter")
            append(f'{PREFIX}slo_bad_total{{{lbl}}} {st["bad"]}')
            typ(PREFIX + "slo_alerts", "counter")
            append(f'{PREFIX}slo_alerts_total{{{lbl}}} {st["alerts"]}')
            typ(PREFIX + "slo_alerting", "gauge")
            append(f'{PREFIX}slo_alerting{{{lbl}}} '
                   f'{1 if st["alerting"] else 0}')
            typ(PREFIX + "slo_burn_rate", "gauge")
            for window, key in (("long", "burn_long"),
                                ("short", "burn_short")):
                append(f'{PREFIX}slo_burn_rate'
                       f'{{{lbl},window="{window}"}} {_fmt(st[key])}')

    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def write_metrics(path: str, snap: TelemetrySnapshot,
                  now: float | None = None) -> str:
    """File sink: render and write, returning the text."""
    text = render_openmetrics(snap, now=now)
    with open(path, "w") as f:
        f.write(text)
    return text


# --------------------------------------------------------------------------
# Parsing (round-trip validation + tooling)
# --------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<series>[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})?)"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>[^\s]+))?$")
_TYPE_RE = re.compile(r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
                      r"(counter|gauge|histogram|summary|unknown)$")


def _parse_value(text: str) -> float:
    if text == "+Inf":
        return float("inf")
    if text == "-Inf":
        return float("-inf")
    return float(text)


def parse_exposition(text: str) -> tuple[dict, dict]:
    """Parse exposition text back into ``(values, types)``.

    ``values`` maps canonical series id -> sample value; ``types`` maps
    family -> declared type.  Raises ``ValueError`` on grammar violations,
    a missing ``# EOF`` terminator, or non-monotone histogram buckets.
    """
    values: dict[str, float] = {}
    types: dict[str, str] = {}
    lines = text.splitlines()
    if not lines or lines[-1] != "# EOF":
        raise ValueError("exposition must end with '# EOF'")
    for lineno, line in enumerate(lines[:-1], 1):
        if not line or line.startswith("#"):
            m = _TYPE_RE.match(line) if line.startswith("# TYPE") else None
            if line.startswith("# TYPE"):
                if m is None:
                    raise ValueError(f"line {lineno}: bad TYPE line {line!r}")
                types[m.group(1)] = m.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: bad sample line {line!r}")
        sid = m.group("series")
        # canonicalize label order so parse(render(x)) keys == x's keys
        name, labels = split_series(sid)
        sid = series(name, labels)
        if sid in values:
            raise ValueError(f"line {lineno}: duplicate series {sid!r}")
        values[sid] = _parse_value(m.group("value"))
    # histogram validity: cumulative buckets must be non-decreasing and
    # close with le="+Inf" equal to _count
    by_hist: dict[str, list] = {}
    for sid, value in values.items():
        name, labels = split_series(sid)
        if name.endswith("_bucket") and "le" in labels:
            base = name[:-len("_bucket")]
            le = labels.pop("le")
            by_hist.setdefault(series(base, labels), []).append(
                (_parse_value(le), value))
    for hist_id, buckets in by_hist.items():
        buckets.sort()
        cum = [v for _, v in buckets]
        if any(b > a for a, b in zip(cum[1:], cum)):
            raise ValueError(f"{hist_id}: non-monotone histogram buckets")
        name, labels = split_series(hist_id)
        count = values.get(series(name + "_count", labels))
        if count is not None and buckets and buckets[-1][1] != count:
            raise ValueError(f"{hist_id}: le='+Inf' bucket != _count")
    return values, types
