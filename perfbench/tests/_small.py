"""A copy of the benchmark at a size the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "uniform1024.backlog": {"length": 64, "batch": 16, "pool": 8},
    "mapreduce1024.backlog": {"length": 64, "batch": 16, "pool": 8},
    "mixed.poisson": {"rate_per_s": 20, "length": {"min": 8, "max": 128},
                      "settle_s": 30},
}


def small_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``perfbench/`` with every
    traffic mix cut to :data:`SMALL`."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for mix, over in SMALL.items():
        path = tmp / "perfbench" / "traffic" / f"{mix}.json"
        data = json.loads(path.read_text())
        data.update(over)
        path.write_text(json.dumps(data))
    return tmp
