"""Sort-as-a-service demo on the PyTorch port: batch submit, streaming
session, async front door (the twin of ``examples/sort_service.py``).

Run:  PYTHONPATH=src python examples/torch/sort_service.py [--device cpu]

The engine's backends run on ``--device``: the colskip and radix CUDA
kernels on ``cuda``, their plain torch versions on ``cpu``.  Every
response is checked against the numpy oracle (``verify=True``); the
verify-failure count printed at the end must be 0.
"""

import argparse

import numpy as np

from repro_torch.sortserve import (
    AsyncSortServe,
    EngineConfig,
    SortRequest,
    SortServeEngine,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    engine = SortServeEngine(EngineConfig(
        backends=("colskip", "radix_topk", "jaxsort"),
        tile_rows=4, banks=4, bank_width=256, bank_rows=4,
        sim_width_cap=256, verify=True, device=args.device))
    rng = np.random.default_rng(0)

    # --- one synchronous batch: a mixed analytics-style workload ----------
    reqs = [
        SortRequest("sort", rng.integers(0, 1 << 20, 100, dtype=np.int64)
                    .astype(np.uint32)),
        SortRequest("argsort", (rng.normal(size=77) * 50).astype(np.float32)),
        SortRequest("topk", rng.normal(size=500).astype(np.float32), k=10),
        SortRequest("kmin", rng.integers(-1000, 1000, 64, dtype=np.int64)
                    .astype(np.int32), k=5),
    ]
    resps = engine.submit(reqs)
    for req, resp in zip(reqs, resps):
        head = (resp.values[:5] if resp.values is not None
                else resp.indices[:5])
        print(f"{req.op:8s} n={req.n:4d} -> backend={resp.backend:10s} "
              f"cycles={resp.cycles} head={head}")

    # --- streaming session: feed as traffic arrives, no flush barrier -----
    session = engine.begin(max_age_s=0.005)
    got = []
    for wave in range(3):                      # three arrival waves
        chunk = [SortRequest("sort",
                             rng.integers(0, 1 << 16, 48, dtype=np.int64)
                             .astype(np.uint32))
                 for _ in range(4)]
        got += session.feed(chunk)             # full buckets dispatch now
    got += session.drain()                     # close stragglers
    st = session.telemetry()
    print(f"session: {st['completed']}/{st['requests']} served in "
          f"{st['tiles']} tiles, "
          f"{st['scheduler_delta']['admissions']} event-clock admissions, "
          f"p95={st['latency_s']['p95'] * 1e3:.2f}ms")

    # --- async: single-request callers coalesced into warm tiles ----------
    server = AsyncSortServe(engine, max_batch=32, max_wait_ms=5.0)
    futures = [
        server.submit(SortRequest("topk", rng.normal(size=200).astype(np.float32), k=3))
        for _ in range(16)
    ]
    results = [f.result(timeout=30) for f in futures]
    server.close()
    print(f"async: {len(results)} responses, "
          f"all same tile shape: {len({r.bucket_shape for r in results}) == 1}")

    telem = engine.telemetry()
    print(f"verify failures: {telem['verify_failures']}")
    assert telem["verify_failures"] == 0
    print(f"bucket hit-rate: {telem['batcher']['bucket_hit_rate']:.2f} "
          f"over {telem['batcher']['tiles']} tiles")
    print(f"per-bank rows served: "
          f"{[b['rows_served'] for b in telem['scheduler']['banks']]}")


if __name__ == "__main__":
    main()
