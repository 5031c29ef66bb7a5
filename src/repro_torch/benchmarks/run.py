"""Benchmark harness of the port — one module per paper table/figure plus
the kernel and serving suites, the twin of the reference's
``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV rows (or a JSON document with
``--json``).  Run:

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--only fig6,...] \\
        [--json] [--out FILE] [--device cuda|cpu]

``--device`` (default ``cuda``; it raises without a card) is where the
kernel and serving suites run: the CUDA kernels on ``cuda``, their plain
torch versions on ``cpu``.  The figure suites run the numpy hardware
models on the host either way.  A derived column ending in ``MISS`` is a
band miss; a suite that raises is reported and makes the exit code 1.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from repro_torch._device import resolve_device

# The reference's suites not ported yet, and what each waits on:
# streaming_bench on the fleet (ROADMAP Queue 1 item 9), distserve_bench
# on the mesh (item 10), hw_bench on the XLA flags and the compile cache,
# which have no counterpart in the port yet.
SUITES = [
    "repro_torch.benchmarks.fig6_speedup",
    "repro_torch.benchmarks.fig7_area_power",
    "repro_torch.benchmarks.fig8a_summary",
    "repro_torch.benchmarks.fig8b_multibank",
    "repro_torch.benchmarks.kernel_bench",
    "repro_torch.benchmarks.serving_bench",
    "repro_torch.benchmarks.sortserve_bench",
    "repro_torch.benchmarks.packed_bench",
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="comma-separated suite substrings")
    ap.add_argument("--json", action="store_true",
                    help="emit a JSON document of rows instead of CSV")
    ap.add_argument("--out", default="",
                    help="also write the JSON document to this file "
                         "(implies structured output)")
    ap.add_argument("--device", default="cuda",
                    help="where the kernel and serving suites run: cuda "
                         "(the CUDA kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    only = [s for s in args.only.split(",") if s]

    rows = []

    def report(name: str, us_per_call: float, derived: str) -> None:
        rows.append((name, us_per_call, derived))
        if not args.json:
            print(f"{name},{us_per_call:.1f},{derived}", flush=True)

    if not args.json:
        print("name,us_per_call,derived")
    failures = []
    for mod_name in SUITES:
        if only and not any(s in mod_name for s in only):
            continue
        try:
            mod = importlib.import_module(mod_name)
            mod.run(report, device=device)
        except Exception as e:  # keep the harness going; report at the end
            failures.append((mod_name, repr(e)))
            if not args.json:
                print(f"{mod_name},0.0,ERROR {e!r}", flush=True)

    n_miss = sum(1 for _, _, d in rows if "MISS" in d)
    doc = {
        "rows": [{"name": n, "us_per_call": u, "derived": d}
                 for n, u, d in rows],
        "band_misses": n_miss,
        "errors": [{"suite": s, "error": e} for s, e in failures],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
    if args.json:
        print(json.dumps(doc, indent=2))
    elif args.out:
        print(f"# wrote {len(rows)} rows -> {args.out}")
    else:
        print(f"# {len(rows)} rows, {n_miss} band misses, {len(failures)} suite errors")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
