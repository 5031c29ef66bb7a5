"""Cross-engine telemetry aggregation: snapshots that merge losslessly.

One engine's ``telemetry()`` is a rendered view — rates, quantiles, ratios
— and rendered views do not compose: you cannot average two p99s or two
EMA ratios and get the fleet's.  :class:`TelemetrySnapshot` captures the
*raw accumulator state* underneath the view instead, in a JSON-friendly
schema whose every section has an exact merge rule:

  ==============  =====================================================
  section         merge rule
  ==============  =====================================================
  counters        sum (monotone totals)
  gauges          last-writer-wins by ``(t, value)`` — deterministic and
                  associative even on clock ties
  maxima          max (high-water marks: queued peak, makespan)
  histograms      log2 buckets merge bucket-wise; count/sum add; the
                  bounded timestamped sample window merges sorted with
                  the newest ``maxlen`` kept
  windows         the windowed counters' raw ``(t, amount)`` event lists
                  merge sorted (rates are re-derived after the merge)
  calibration     per-(backend, width) ``[tiles, wall_s, cycles]`` sums
                  add — pooling weighted by sample count, so the merged
                  ratio is the fleet's true wall/modeled ratio
  slo             per-(class, SLI) event lists merge sorted; alert
                  counts add; burn rates are re-evaluated on render
  ==============  =====================================================

Merging is associative and commutative, so folding N snapshots in any
partition order yields the same fleet view (pinned by a hypothesis
property in ``tests/test_obs_export.py``) — the substrate
a fleet view (not yet ported; ``repro.sortserve.fleet``) folds to treat
"three replicas" and "one bigger replica" uniformly (retired engines
from rolling restarts included).

Capture via :meth:`SortServeEngine.telemetry_snapshot` (which holds the
engine lock), persist with :meth:`TelemetrySnapshot.dump` /
:meth:`TelemetrySnapshot.load`, fold with :func:`merge_snapshots`, and
render either the human view (:meth:`TelemetrySnapshot.fleet_view`) or
the OpenMetrics exposition (:mod:`repro_torch.obs.export`).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field

from repro_torch.obs.slo import SLOTarget, burn_rates

__all__ = ["TelemetrySnapshot", "capture", "merge_snapshots", "series"]

PREFIX = "sortserve_"

SCHEMA_VERSION = 1


def _escape(value) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def series(name: str, labels: dict | None = None) -> str:
    """Canonical series id: ``name{k="v",...}`` with labels sorted, so the
    same logical series from two engines gets the same key."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def split_series(sid: str) -> tuple[str, dict]:
    """Inverse of :func:`series` (no escaped quotes inside label values —
    telemetry labels here are backend/op/class/width names)."""
    if "{" not in sid:
        return sid, {}
    name, _, rest = sid.partition("{")
    labels = {}
    for part in rest.rstrip("}").split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        labels[k] = v.strip('"')
    return name, labels


@dataclass
class TelemetrySnapshot:
    """One engine's raw telemetry state (or a merged fleet's)."""

    sources: list = field(default_factory=list)
    captured_at: float = 0.0
    clock_hz: float = 0.0
    counters: dict = field(default_factory=dict)
    gauges: dict = field(default_factory=dict)       # series -> [t, value]
    maxima: dict = field(default_factory=dict)
    histograms: dict = field(default_factory=dict)
    windows: dict = field(default_factory=dict)
    calibration: dict = field(default_factory=dict)  # "be|width" -> [n,w,c]
    slo: dict = field(default_factory=dict)
    version: int = SCHEMA_VERSION

    # ------------------------------------------------------------------ merge
    def merge(self, other: "TelemetrySnapshot") -> "TelemetrySnapshot":
        """Fold two snapshots into a new one (self and other untouched)."""
        out = TelemetrySnapshot(
            sources=sorted(set(self.sources) | set(other.sources)),
            captured_at=max(self.captured_at, other.captured_at),
            clock_hz=max(self.clock_hz, other.clock_hz),
        )
        for sid in set(self.counters) | set(other.counters):
            out.counters[sid] = (self.counters.get(sid, 0)
                                 + other.counters.get(sid, 0))
        for sid in set(self.maxima) | set(other.maxima):
            out.maxima[sid] = max(self.maxima.get(sid, float("-inf")),
                                  other.maxima.get(sid, float("-inf")))
        for sid in set(self.gauges) | set(other.gauges):
            cands = [tuple(g[sid]) for g in (self.gauges, other.gauges)
                     if sid in g]
            out.gauges[sid] = list(max(cands))   # LWW by (t, value)
        for sid in set(self.histograms) | set(other.histograms):
            out.histograms[sid] = _merge_hist(self.histograms.get(sid),
                                              other.histograms.get(sid))
        for sid in set(self.windows) | set(other.windows):
            out.windows[sid] = _merge_window(self.windows.get(sid),
                                             other.windows.get(sid))
        for key in set(self.calibration) | set(other.calibration):
            a = self.calibration.get(key, [0, 0.0, 0.0])
            b = other.calibration.get(key, [0, 0.0, 0.0])
            out.calibration[key] = [a[0] + b[0], a[1] + b[1], a[2] + b[2]]
        out.slo = _merge_slo(self.slo, other.slo)
        return out

    # ------------------------------------------------------------------- I/O
    def to_json(self) -> str:
        return json.dumps(self.__dict__, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TelemetrySnapshot":
        raw = json.loads(text)
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in raw.items() if k in known})

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TelemetrySnapshot":
        with open(path) as f:
            return cls.from_json(f.read())

    # ------------------------------------------------------------ fleet view
    def fleet_view(self, now: float | None = None) -> dict:
        """Human-readable derived view of a (possibly merged) snapshot:
        windowed rates, exact latency quantiles over the merged sample
        window, pooled calibration ratios, re-evaluated SLO burn rates."""
        now = self.captured_at if now is None else now
        view: dict = {
            "sources": list(self.sources),
            "captured_at": self.captured_at,
            "requests": self.counters.get(PREFIX + "requests_total", 0),
            "counters": dict(self.counters),
            "gauges": {sid: g[1] for sid, g in sorted(self.gauges.items())},
            "maxima": dict(self.maxima),
        }
        window: dict = {}
        for short in ("requests", "tiles", "shed", "failed"):
            w = self.windows.get(PREFIX + "window_" + short)
            if w is None:
                continue
            horizon = now - w["window_s"]
            in_win = [(t, a) for t, a in w["events"] if t > horizon]
            window[short] = sum(a for _, a in in_win)
            first_t = w.get("first_t")
            span = (max(min(w["window_s"], now - first_t), 1e-9)
                    if first_t is not None else None)
            if span is not None and short in ("requests", "tiles"):
                window[short + "_per_s"] = window[short] / span
        n_req, n_shed = window.get("requests", 0), window.get("shed", 0)
        window["shed_rate"] = n_shed / max(1, n_req + n_shed)
        lat = self.histograms.get(PREFIX + "latency_seconds")
        if lat is not None:
            horizon = now - lat["window_s"]
            vals = sorted(v for t, v in lat["samples"] if t >= horizon)
            window["latency_s"] = {
                "mean": sum(vals) / len(vals) if vals else 0.0,
                "p50": _nearest_rank(vals, 50),
                "p99": _nearest_rank(vals, 99),
            }
        view["window"] = window
        table: dict = {}
        for key, (tiles, wall, cyc) in sorted(self.calibration.items()):
            backend, _, width = key.partition("|")
            modeled_s = cyc / self.clock_hz if self.clock_hz > 0 else 0.0
            table.setdefault(backend, {})[width] = {
                "tiles": tiles, "wall_s": wall, "modeled_s": modeled_s,
                "ratio": wall / modeled_s if modeled_s > 0 else 0.0,
            }
        view["calibration"] = table
        view["slo"] = evaluate_slo(self.slo, now)
        return view


def _nearest_rank(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    rank = min(len(sorted_vals) - 1,
               max(0, math.ceil(q / 100.0 * len(sorted_vals)) - 1))
    return sorted_vals[rank]


def _merge_sorted_capped(a: list, b: list, maxlen: int | None) -> list:
    """Merge two timestamped lists into one total (t, ...) order, keeping
    the newest ``maxlen``.  Capping keeps associativity: an entry dropped
    early could never be among the newest ``maxlen`` of the full union."""
    merged = sorted([tuple(x) for x in a] + [tuple(x) for x in b])
    if maxlen is not None and len(merged) > maxlen:
        merged = merged[-maxlen:]
    return [list(x) for x in merged]


def _merge_hist(a: dict | None, b: dict | None) -> dict:
    if a is None or b is None:
        src = a if b is None else b
        return {**src, "buckets": dict(src["buckets"]),
                "samples": [list(x) for x in src["samples"]]}
    out = {"lo": a["lo"], "window_s": a["window_s"], "maxlen": a["maxlen"],
           "count": a["count"] + b["count"], "sum": a["sum"] + b["sum"],
           "buckets": dict(a["buckets"])}
    for bucket, n in b["buckets"].items():
        out["buckets"][bucket] = out["buckets"].get(bucket, 0) + n
    out["samples"] = _merge_sorted_capped(a["samples"], b["samples"],
                                          a["maxlen"])
    return out


def _merge_window(a: dict | None, b: dict | None) -> dict:
    if a is None or b is None:
        src = a if b is None else b
        return {**src, "events": [list(x) for x in src["events"]]}
    firsts = [t for t in (a.get("first_t"), b.get("first_t"))
              if t is not None]
    return {
        "window_s": a["window_s"], "maxlen": a["maxlen"],
        "first_t": min(firsts) if firsts else None,
        "all_time": a["all_time"] + b["all_time"],
        "events": _merge_sorted_capped(a["events"], b["events"],
                                       a["maxlen"]),
    }


def _merge_slo(a: dict, b: dict) -> dict:
    out: dict = {}
    for cls in set(a) | set(b):
        if cls not in a or cls not in b:
            src = a.get(cls) or b.get(cls)
            out[cls] = json.loads(json.dumps(src))     # deep copy
            continue
        sa, sb = a[cls], b[cls]
        merged = {"target": dict(sa["target"]), "slis": {}}
        for sli in set(sa["slis"]) | set(sb["slis"]):
            xa = sa["slis"].get(sli, {"events": [], "good": 0, "bad": 0,
                                      "alerts": 0, "alerting": False})
            xb = sb["slis"].get(sli, {"events": [], "good": 0, "bad": 0,
                                      "alerts": 0, "alerting": False})
            merged["slis"][sli] = {
                "events": _merge_sorted_capped(xa["events"], xb["events"],
                                               8192),
                "good": xa["good"] + xb["good"],
                "bad": xa["bad"] + xb["bad"],
                "alerts": xa["alerts"] + xb["alerts"],
                "alerting": xa["alerting"] or xb["alerting"],
            }
        out[cls] = merged
    return out


def evaluate_slo(slo_state: dict, now: float) -> dict:
    """Re-evaluate burn rates of a (merged) snapshot's SLO state at
    ``now`` — same math the live tracker uses, over the merged events."""
    out: dict = {}
    for cls, sub in sorted(slo_state.items()):
        target = SLOTarget(**sub["target"])
        per: dict = {}
        for sli, st in sorted(sub["slis"].items()):
            burn_long, burn_short = burn_rates(st["events"], now, target,
                                               sli)
            per[sli] = {
                "good": st["good"], "bad": st["bad"],
                "alerts": st["alerts"], "alerting": st["alerting"],
                "burn_long": burn_long, "burn_short": burn_short,
                "budget": target.budget(sli),
            }
        out[cls] = per
    return out


def merge_snapshots(snapshots) -> TelemetrySnapshot:
    """Fold any iterable of snapshots into one fleet snapshot."""
    out = TelemetrySnapshot()
    for snap in snapshots:
        out = out.merge(snap)
    return out


# --------------------------------------------------------------------------
# Engine capture
# --------------------------------------------------------------------------

def capture(engine, source: str | None = None,
            now: float | None = None) -> TelemetrySnapshot:
    """Snapshot one engine's raw telemetry state.

    Call via :meth:`SortServeEngine.telemetry_snapshot`, which holds the
    engine lock — this function reads live accumulators and must see a
    consistent instant."""
    now = engine._clock() if now is None else now
    m = engine._metrics
    agg = engine._agg
    sched = engine.scheduler
    s = sched.stats
    snap = TelemetrySnapshot(
        sources=[source if source is not None else "engine"],
        captured_at=now,
        clock_hz=engine._calib.clock_hz,
    )
    c = snap.counters
    # unlabeled series ids are the bare metric name (see series()); the
    # direct f-strings below keep a scrape inside the export-overhead gate
    c[PREFIX + "requests_total"] = agg["requests"]
    c[PREFIX + "column_reads_total"] = agg["column_reads"]
    c[PREFIX + "cycles_exact_total"] = agg["cycles_exact"]
    c[PREFIX + "cycles_estimated_total"] = agg["cycles_estimated"]
    c[PREFIX + "verify_failures_total"] = agg["verify_failures"]
    c[PREFIX + "result_cache_hits_total"] = agg["cache_hits"]
    c[PREFIX + "result_cache_misses_total"] = agg["cache_misses"]
    for key in ("hits", "misses", "prewarmed"):
        c[f"{PREFIX}executor_cache_{key}_total"] = engine._exec_stats[key]
    # process-global split (same scope as the live executor_cache section);
    # imported here because sortserve.engine imports this module at load
    from repro_torch.sortserve.backends import EXECUTOR_CACHE
    p_hits, p_misses = EXECUTOR_CACHE.persistent_counters()
    c[PREFIX + "executor_cache_persistent_hits_total"] = p_hits
    c[PREFIX + "executor_cache_persistent_misses_total"] = p_misses
    coll = agg["collectives"]
    for key in ("rounds", "planes", "unfused_rounds", "prefetch_staged",
                "prefetch_hits"):
        c[f"{PREFIX}collectives_{key}_total"] = coll[key]
    c[PREFIX + "shed_requests_total"] = m.shed.all_time
    c[PREFIX + "failed_requests_total"] = m.failed.all_time
    for backend, pb in sorted(agg["per_backend"].items()):
        lbl = f'{{backend="{_escape(backend)}"}}'
        c[f"{PREFIX}backend_tiles_total{lbl}"] = pb["tiles"]
        c[f"{PREFIX}backend_requests_total{lbl}"] = pb["requests"]
        c[f"{PREFIX}backend_rows_total{lbl}"] = pb["rows"]
        c[f"{PREFIX}backend_column_reads_total{lbl}"] = pb["column_reads"]
        c[f"{PREFIX}backend_wall_seconds_total{lbl}"] = pb["wall_s"]
    for op, n in sorted(agg["per_op"].items()):
        c[f'{PREFIX}op_requests_total{{op="{_escape(op)}"}}'] = n
    bs = engine.batcher.stats
    c[PREFIX + "batcher_tiles_total"] = bs.tiles
    c[PREFIX + "batcher_requests_total"] = bs.requests
    c[PREFIX + "batcher_pad_rows_total"] = bs.pad_rows
    for name in ("tiles", "drains", "oversized_tiles", "oversized_waves",
                 "mid_wave_admissions", "arrivals", "admissions", "events",
                 "exec_failures", "deferred", "shed"):
        c[f"{PREFIX}sched_{name}_total"] = getattr(s, name)
    c[PREFIX + "sched_queue_wait_cycles_total"] = s.queue_wait_vt
    c[PREFIX + "sched_busy_bank_cycles_total"] = s.busy_bank_vt
    c[PREFIX + "fault_failures_total"] = s.fault_failures
    c[PREFIX + "fault_retries_total"] = s.retries
    c[PREFIX + "fault_exhausted_total"] = s.fault_exhausted
    c[PREFIX + "fault_guard_failures_total"] = \
        engine._fault_agg["guard_failures"]
    c[PREFIX + "fault_fallbacks_total"] = engine._fault_agg["fallbacks"]
    health = engine._health.section()
    c[PREFIX + "fault_quarantines_total"] = health["quarantines"]
    c[PREFIX + "fault_reinstated_total"] = health["reinstated"]
    snap.gauges[PREFIX + "quarantined_banks"] = \
        [now, health["quarantined_now"]]
    c[PREFIX + "watermark_crossings_total"] = \
        getattr(sched.policy, "crossings", 0)
    for bank in engine.pool.banks:
        lbl = f'{{bank="{bank.index}"}}'
        c[f"{PREFIX}bank_tiles_served_total{lbl}"] = bank.tiles_served
        c[f"{PREFIX}bank_rows_served_total{lbl}"] = bank.rows_served
        c[f"{PREFIX}bank_busy_cycles_total{lbl}"] = bank.busy_cycles

    snap.maxima[PREFIX + "queued_peak"] = s.queued_peak
    snap.maxima[PREFIX + "max_banks_in_flight"] = s.max_banks_in_flight
    snap.maxima[PREFIX + "makespan_cycles"] = s.makespan_vt

    m.queue_depth_g.set(now, sched.queue_depth())
    snap.gauges[PREFIX + "queue_depth"] = list(m.queue_depth_g.snapshot())
    snap.gauges[PREFIX + "occupancy"] = list(m.occupancy_g.snapshot())
    snap.gauges[PREFIX + "retry_after_seconds"] = \
        [now, engine._retry_after_at(now)]
    snap.gauges[PREFIX + "drain_rate_cycles"] = \
        [now, sched.drain_rate_vt()]

    for name, hist in (("latency_seconds", m.latency),
                       ("occupancy_ratio", m.occupancy)):
        snap.histograms[PREFIX + name] = {
            "lo": hist.lo, "window_s": hist.window_s,
            "maxlen": hist._samples.maxlen,
            "buckets": {str(b): n for b, n in sorted(hist.buckets.items())},
            "count": hist.all_time_count, "sum": hist.all_time_sum,
            # list(deque) keeps the tuples: JSON writes tuples and lists
            # identically, and the C-level copy keeps scrapes cheap
            "samples": list(hist._samples),
        }
    for short in ("requests", "tiles", "shed", "failed"):
        wc = getattr(m, short)
        snap.windows[PREFIX + "window_" + short] = {
            "window_s": wc.window_s, "maxlen": wc._events.maxlen,
            "first_t": wc.first_t, "all_time": wc.all_time,
            "events": list(wc._events),
        }
    snap.calibration = {f"{backend}|{width}": list(sums)
                        for (backend, width), sums
                        in sorted(engine._calib._sums.items())}
    if engine._slo is not None:
        snap.slo = engine._slo.state()
    return snap
