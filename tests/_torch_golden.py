"""The golden-telemetry surface of test_continuous.py, for the port's
engine (imports no jax, so the card's tests can use it too)."""

import hashlib
import json
import pathlib

import numpy as np

from repro_torch.launch.sortserve import make_workload

GOLDEN = pathlib.Path(__file__).parent / "golden" / "continuous_telemetry.json"
GOLDEN_CFG = dict(backends=("colskip", "radix_topk", "jaxsort", "numpy"),
                  tile_rows=4, min_bucket=8, banks=4, bank_width=64,
                  bank_rows=4, sim_width_cap=128, cache_size=0,
                  adaptive_policy=False)


def _digest(arr):
    if arr is None:
        return None
    h = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]
    return f"{h}:{arr.dtype}:{arr.shape}"


def golden_payload(engine) -> dict:
    """test_continuous.golden_payload's surface, served by ``engine``: the
    seed-21 flushed workload's per-response digests plus aggregates."""
    got = engine.submit(make_workload(40, min_len=8, max_len=128, seed=21))
    telem = engine.telemetry()
    banks = telem["scheduler"]["banks"]
    return {
        "responses": [
            {"backend": r.backend, "cycles": r.cycles,
             "column_reads": r.column_reads,
             "bucket_shape": list(r.bucket_shape),
             "values": _digest(r.values), "indices": _digest(r.indices)}
            for r in got],
        "aggregate": {
            "column_reads": telem["column_reads"],
            "cycles_exact": telem["cycles_exact"],
            "cycles_estimated": telem["cycles_estimated"],
            "tiles": telem["scheduler"]["tiles"],
            "bank_totals": [sum(b["tiles_served"] for b in banks),
                            sum(b["rows_served"] for b in banks),
                            sum(b["busy_cycles"] for b in banks)],
        },
    }


def golden_text(payload) -> str:
    """The payload as the golden file stores it."""
    return json.dumps(json.loads(json.dumps(payload)), indent=2,
                      sort_keys=True)
