"""Flight recorder demo on the PyTorch port: trace a mixed workload, dump a
Perfetto-viewable Chrome trace, and print the measured-vs-modeled
calibration table (the twin of ``examples/trace_requests.py``).

Run:  PYTHONPATH=src python examples/torch/trace_requests.py [--device cpu]

Serves two rounds of a mixed sort/argsort/topk/kmin stream through a traced
engine on ``--device`` — the first round builds the launchers (and, on the
card, loads the kernel libraries), the second runs warm (only warm
executions feed the calibration ratios) — then writes ``trace.json`` in
the working directory for https://ui.perfetto.dev and summarizes what the
recorder saw.
"""

import argparse

from repro_torch.launch.sortserve import make_workload
from repro_torch.obs import Tracer
from repro_torch.sortserve import EngineConfig, SortServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    tracer = Tracer(capacity=4096)
    engine = SortServeEngine(EngineConfig(tracer=tracer, cache_size=0,
                                          device=args.device))

    # --- 1. serve two rounds: cold (compiles) then warm ------------------
    for rnd in range(2):
        reqs = make_workload(60, min_len=16, max_len=512, seed=11 + rnd)
        engine.submit(reqs)
        print(f"[round {rnd}] served {len(reqs)} requests "
              f"({'cold builds' if rnd == 0 else 'warm launchers'})")

    # --- 2. dump the Chrome trace ----------------------------------------
    doc = engine.dump_trace("trace.json")
    spans = sum(ev.get("ph") == "X" for ev in doc["traceEvents"])
    print(f"[trace] {tracer.span_count()} request chains, {spans} spans "
          f"-> trace.json (open at https://ui.perfetto.dev)")

    # --- 3. one chain, both time domains ---------------------------------
    chain = tracer.chains[-1]
    rec = chain["tile"]
    print(f"[chain rid={chain['rid']}] {chain['op']} n={chain['n']}: "
          f"wall {chain['t_done'] - chain['t_feed']:.4f}s; "
          f"vt arrive={rec['arrive_vt']:.0f} admit={rec['admit_vt']:.0f} "
          f"retire={rec['retire_vt']:.0f} cyc on banks {rec['bank_ids']}")

    # --- 4. the calibration table ----------------------------------------
    telem = engine.telemetry()
    print(f"[window] last {telem['window']['window_s']:.0f}s: "
          f"{telem['window']['requests_per_s']:.1f} req/s, "
          f"p99 {telem['window']['latency_s']['p99']:.4f}s")
    print("[calibration] measured wall vs modeled cycles (warm tiles only):")
    print(f"  {'backend':<14} {'width':>6} {'tiles':>6} "
          f"{'wall_s':>10} {'modeled_s':>10} {'ratio':>10}")
    for backend, widths in telem["calibration"].items():
        for width, cell in widths.items():
            print(f"  {backend:<14} {width:>6} {cell['tiles']:>6} "
                  f"{cell['wall_s']:>10.4f} {cell['modeled_s']:>10.6f} "
                  f"{cell['ratio']:>10.1f}")


if __name__ == "__main__":
    main()
