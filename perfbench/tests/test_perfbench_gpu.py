"""One short cell on the card, through the command the driver runs."""

import json
import subprocess
import sys

import pytest

from _small import REPO


@pytest.mark.gpu
def test_a_short_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "csk.uniform1024.backlog", "--seed", "4294967301", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=1200,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"setup_s", "elems_per_s"}
