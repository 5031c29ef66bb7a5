"""Flight-recorder observability: span tracing, windowed metrics,
measured-vs-modeled calibration, cross-engine aggregation, OpenMetrics
export, and SLO burn-rate tracking.

Everything here is engine-facing and clock-explicit: the engine injects
its own clock readings into every hook, so all of it is deterministic
under a fake clock and adds nothing to the serving path when unused.
"""

from repro_torch.obs.aggregate import TelemetrySnapshot, merge_snapshots
from repro_torch.obs.calibration import CalibrationTable
from repro_torch.obs.export import (parse_exposition, render_openmetrics,
                                    write_metrics)
from repro_torch.obs.metrics import (Gauge, LogBucketHistogram,
                                     MetricsRegistry, WindowedCounter)
from repro_torch.obs.slo import SLOTarget, SLOTracker
from repro_torch.obs.tracer import Tracer

__all__ = [
    "CalibrationTable",
    "Gauge",
    "LogBucketHistogram",
    "MetricsRegistry",
    "SLOTarget",
    "SLOTracker",
    "TelemetrySnapshot",
    "Tracer",
    "WindowedCounter",
    "merge_snapshots",
    "parse_exposition",
    "render_openmetrics",
    "write_metrics",
]
