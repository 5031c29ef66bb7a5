"""What one stage span of the serving engine costs the host.

    python3 scripts/stage_cost.py [--spans 200000] [--repeats 5]

Times, in microseconds a span, the primitive behind
``telemetry()["stages"]`` (``repro_torch.obs.tracer.Stages``, with no
tracer: the counters, and the profiler range while a profiler records)
and the pieces it is made of: ``torch.autograd._profiler_enabled()``,
``torch._C._profiler._RecordFunctionFast`` and
``torch.profiler.record_function`` entered and left.  Each is timed with
no profiler running and under ``torch.profiler`` (CPU activity, and CUDA
activity where a card is present), ``--spans`` spans a repeat; the
median of ``--repeats`` is printed.  Runs on the CPU too; on a machine
with an NVIDIA card its name and power limit come first.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def per_span_us(body, spans: int, repeats: int) -> float:
    runs = []
    for _ in range(repeats):
        t = time.perf_counter()
        body(spans)
        runs.append((time.perf_counter() - t) / spans * 1e6)
    return statistics.median(runs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spans", type=int, default=200_000)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.tracer import Stages

    if torch.cuda.is_available():
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)

    stages = Stages()
    stage = stages.stage
    enabled = torch.autograd._profiler_enabled
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    slow = torch.profiler.record_function

    def span(n):
        for _ in range(n):
            with stage("sortserve.probe"):
                pass

    def probe(n):
        for _ in range(n):
            enabled()

    def ranges(ctor):
        def body(n):
            for _ in range(n):
                with ctor("probe"):
                    pass
        return body

    bodies = {"Stages span": span, "_profiler_enabled()": probe,
              "record_function": ranges(slow)}
    if fast is not None:
        bodies["_RecordFunctionFast"] = ranges(fast)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    for name, body in bodies.items():
        body(1000)                                    # warm
        off = per_span_us(body, args.spans, args.repeats)
        with profile(activities=activities):
            on = per_span_us(body, args.spans // 4, args.repeats)
        print(f"{name}: {off:.3f} us with no profiler, {on:.3f} us under "
              "torch.profiler")
    return 0


if __name__ == "__main__":
    sys.exit(main())
