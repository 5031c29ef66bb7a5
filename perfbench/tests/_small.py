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

SMALL = Path(__file__).resolve().parent / "small"


def small_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``perfbench/`` with each
    traffic mix ``<mix>`` cut to ``small/<mix>.json``, key by key, where
    that file exists."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cut in sorted(SMALL.glob("*.json")):
        path = tmp / "perfbench" / "traffic" / cut.name
        data = json.loads(path.read_text())
        data.update(json.loads(cut.read_text()))
        path.write_text(json.dumps(data))
    return tmp
