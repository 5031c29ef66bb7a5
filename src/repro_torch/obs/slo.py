"""Per-traffic-class SLO tracking with multi-window burn-rate alerting.

A serving objective only means something per traffic class: the bulk
analytics class that tolerates seconds is not the interactive class that
budgets milliseconds.  :class:`SLOTracker` watches two SLIs per configured
class, fed by the engine at the same hook points that feed the windowed
metrics (so everything runs on the engine's injectable clock and is
deterministic under a fake clock):

  * **latency** — a completed request is *good* iff its feed-to-retire
    latency is <= ``p99_latency_s``; the error budget is
    ``1 - latency_objective`` (e.g. objective 0.99 budgets 1% of requests
    over the threshold);
  * **shed** — every admission outcome is an event: completions are good,
    admission-policy sheds are bad; the error budget is
    ``shed_rate_target`` (the shed fraction the class is allowed).

Alerting is the standard multi-window, multi-burn-rate scheme: with
``budget`` the allowed bad fraction, the *burn rate* over a window is
``bad_fraction / budget`` (1.0 = spending the budget exactly as fast as
allowed).  The tracker alerts when **both** a long (~60 s) and a short
(~5 s) window burn faster than ``burn_threshold`` — the long window gives
significance, the short window confirms the problem is *still happening*
— and clears once the short-window burn drops back under the threshold.
State only changes at event time (never at telemetry render), so a
telemetry read is side-effect free and the alert sequence for a given
trace is reproducible bit for bit.

Alert transitions are surfaced three ways: ``telemetry()["slo"]``
(rendered by :meth:`SLOTracker.section`), an ALERT instant in the
tracer event stream (visible on the scheduler-events track of the Chrome
trace), and the ``sortserve_slo_*`` series of the OpenMetrics exposition
(:mod:`repro_torch.obs.export`).  ``scripts/slo_report.py`` renders the section
from a live run or a dumped snapshot.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

__all__ = ["SLOTarget", "SLOTracker", "burn_rates"]

# the two SLIs every configured class is tracked on
SLIS = ("latency", "shed")

_EPS = 1e-9


@dataclass(frozen=True)
class SLOTarget:
    """One traffic class's objectives + alerting windows."""

    p99_latency_s: float = 0.05      # latency SLI: good iff latency <= this
    latency_objective: float = 0.99  # fraction of requests that must be good
    shed_rate_target: float = 0.01   # shed SLI: allowed shed fraction
    long_window_s: float = 60.0      # significance window
    short_window_s: float = 5.0      # still-happening window
    burn_threshold: float = 14.4     # alert when BOTH windows burn >= this

    def __post_init__(self):
        if self.p99_latency_s <= 0:
            raise ValueError("p99_latency_s must be positive")
        if not 0.0 < self.latency_objective < 1.0:
            raise ValueError("latency_objective must be in (0, 1)")
        if not 0.0 < self.shed_rate_target <= 1.0:
            raise ValueError("shed_rate_target must be in (0, 1]")
        if self.short_window_s <= 0 or \
                self.long_window_s <= self.short_window_s:
            raise ValueError("need 0 < short_window_s < long_window_s")
        if self.burn_threshold <= 0:
            raise ValueError("burn_threshold must be positive")

    def budget(self, sli: str) -> float:
        """Allowed bad fraction for one SLI (never zero)."""
        if sli == "latency":
            return max(1.0 - self.latency_objective, _EPS)
        return max(self.shed_rate_target, _EPS)


def burn_rates(events, now: float, target: SLOTarget,
               sli: str) -> tuple[float, float]:
    """(long, short) window burn rates from timestamped ``(t, bad)`` events.

    Pure function of the event list — the aggregation layer re-evaluates
    merged fleets with it, and the tracker uses it live.  Windows with no
    events burn at 0.0 (no evidence is not bad evidence).
    """
    budget = target.budget(sli)
    long_h = now - target.long_window_s
    short_h = now - target.short_window_s
    lt = lb = st = sb = 0
    for t, b in events:                 # one pass covers both windows:
        if t > long_h:                  # short_h >= long_h always
            lt += 1
            lb += b
            if t > short_h:
                st += 1
                sb += b
    return ((lb / lt) / budget if lt else 0.0,
            (sb / st) / budget if st else 0.0)


class _SliState:
    """Event window + alert latch for one (class, SLI) cell."""

    __slots__ = ("events", "good", "bad", "alerts", "alerting", "alert_t")

    def __init__(self):
        self.events: deque = deque(maxlen=8192)   # (t, bad 0/1)
        self.good = 0                             # all-time counts
        self.bad = 0
        self.alerts = 0                           # transitions into alerting
        self.alerting = False
        self.alert_t = float("-inf")              # t of the last transition

    def snapshot(self) -> tuple:
        return (list(self.events), self.good, self.bad, self.alerts,
                self.alerting, self.alert_t)

    def restore(self, snap: tuple) -> None:
        events, self.good, self.bad, self.alerts, self.alerting, \
            self.alert_t = snap
        self.events = deque(events, maxlen=self.events.maxlen)


class SLOTracker:
    """Multi-class, multi-window burn-rate tracker on an injected clock.

    ``targets`` maps traffic-class name -> :class:`SLOTarget`.  Events for
    classes outside the map (including ``None``, the classless default) are
    ignored — SLOs are opt-in per class, like everything else in obs/.
    """

    def __init__(self, targets: dict[str, SLOTarget]):
        for name, target in targets.items():
            if not isinstance(target, SLOTarget):
                raise TypeError(
                    f"slo[{name!r}] must be an SLOTarget, got "
                    f"{type(target).__name__}")
        self.targets = dict(targets)
        self._state = {cls: {sli: _SliState() for sli in SLIS}
                       for cls in self.targets}

    # ------------------------------------------------------------- recording
    def record_done(self, now: float, traffic_class: str | None,
                    latency_s: float, *, vt: float = 0.0,
                    tracer=None) -> None:
        """A request of this class completed with ``latency_s``."""
        if traffic_class not in self.targets:
            return
        target = self.targets[traffic_class]
        self._observe(traffic_class, "latency", now,
                      bad=latency_s > target.p99_latency_s,
                      vt=vt, tracer=tracer)
        self._observe(traffic_class, "shed", now, bad=False,
                      vt=vt, tracer=tracer)

    def record_shed(self, now: float, traffic_class: str | None, *,
                    vt: float = 0.0, tracer=None) -> None:
        """A request of this class was shed by the admission policy."""
        if traffic_class not in self.targets:
            return
        self._observe(traffic_class, "shed", now, bad=True,
                      vt=vt, tracer=tracer)

    def _observe(self, cls: str, sli: str, now: float, bad: bool,
                 vt: float, tracer) -> None:
        target = self.targets[cls]
        st = self._state[cls][sli]
        st.events.append((now, 1 if bad else 0))
        if bad:
            st.bad += 1
        else:
            st.good += 1
        # prune beyond the long window (the deque maxlen is only a backstop)
        horizon = now - target.long_window_s
        ev = st.events
        while ev and ev[0][0] <= horizon:
            ev.popleft()
        burn_long, burn_short = burn_rates(ev, now, target, sli)
        thr = target.burn_threshold
        if not st.alerting and burn_long >= thr and burn_short >= thr:
            # transition in: the page-worthy instant — count it once and
            # drop an ALERT into the flight recorder's event stream
            st.alerting = True
            st.alerts += 1
            st.alert_t = now
            if tracer is not None:
                tracer.alert(vt, now, cls, sli, burn_long, burn_short)
        elif st.alerting and burn_short < thr:
            # fast clear: the short window says the problem stopped
            st.alerting = False
            st.alert_t = now

    # ------------------------------------------------------------- rendering
    def section(self, now: float) -> dict:
        """The ``telemetry()["slo"]`` section: every configured class,
        every SLI, with burn rates evaluated at ``now``.  Read-only —
        alert state only changes at event time."""
        out: dict[str, dict] = {}
        for cls in sorted(self.targets):
            target = self.targets[cls]
            per = {}
            for sli in SLIS:
                st = self._state[cls][sli]
                burn_long, burn_short = burn_rates(st.events, now, target,
                                                   sli)
                per[sli] = {
                    "objective": (target.latency_objective
                                  if sli == "latency"
                                  else 1.0 - target.shed_rate_target),
                    "budget": target.budget(sli),
                    "good": st.good,
                    "bad": st.bad,
                    "burn_long": burn_long,
                    "burn_short": burn_short,
                    "alerting": st.alerting,
                    "alerts": st.alerts,
                }
            per["latency"]["threshold_s"] = target.p99_latency_s
            per["config"] = {
                "long_window_s": target.long_window_s,
                "short_window_s": target.short_window_s,
                "burn_threshold": target.burn_threshold,
            }
            out[cls] = per
        return out

    # ---------------------------------------------------- snapshot/rollback
    def snapshot(self) -> dict:
        return {cls: {sli: st.snapshot() for sli, st in per.items()}
                for cls, per in self._state.items()}

    def restore(self, snap: dict) -> None:
        for cls, per in snap.items():
            for sli, sub in per.items():
                self._state[cls][sli].restore(sub)

    # ------------------------------------------------------- aggregation I/O
    def state(self) -> dict:
        """JSON-friendly raw state for :class:`repro_torch.obs.aggregate
        .TelemetrySnapshot`: per (class, SLI) the timestamped events and
        all-time counts, plus the target config needed to re-evaluate burn
        rates after a merge."""
        out: dict[str, dict] = {}
        for cls in sorted(self.targets):
            target = self.targets[cls]
            out[cls] = {
                "target": {
                    "p99_latency_s": target.p99_latency_s,
                    "latency_objective": target.latency_objective,
                    "shed_rate_target": target.shed_rate_target,
                    "long_window_s": target.long_window_s,
                    "short_window_s": target.short_window_s,
                    "burn_threshold": target.burn_threshold,
                },
                "slis": {
                    sli: {
                        # list(deque) keeps tuples — JSON-identical to
                        # lists, and a scrape-cheap C-level copy
                        "events": list(st.events),
                        "good": st.good,
                        "bad": st.bad,
                        "alerts": st.alerts,
                        "alerting": st.alerting,
                    }
                    for sli, st in self._state[cls].items()
                },
            }
        return out
