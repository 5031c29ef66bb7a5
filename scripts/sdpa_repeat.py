"""Does gemma3-4b's ``generate`` repeat with cuDNN's attention allowed?

    python3 scripts/sdpa_repeat.py [--repeats 4]

Needs an NVIDIA card and nvcc (the sampler's radix kernel).  Draws
gemma3-4b at its full config (bf16, seed 0) and runs ``generate`` (B = 1,
prompt 1536 from ``default_rng(0)``, 16 new tokens, top_k 64, top_p 0.9,
generator seed 1) ``--repeats`` times twice: once with the backends the
port lets ``F.scaled_dot_product_attention`` choose from
(``models/blocks.py:_BACKENDS``: flash, memory-efficient, math), once with
cuDNN's attention added to them.  Prints, for each, which repeats gave the
first run's tokens.  Also prints the host time of one small eager op on
the card (``a + 1`` on 8 floats, 2,000 times), the unit a decode step's
host time is made of.  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from torch.nn.attention import SDPBackend
    from repro_torch.configs import get_config
    from repro_torch.models import api, blocks
    from repro_torch.serve import generate

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    a = torch.ones(8, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        a = a + 1
    op_us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    print(f"{card}: one small eager op (a + 1) enqueues in {op_us:.2f} us "
          "of host time")

    cfg = get_config("gemma3-4b")
    model = api.init(cfg, seed=0, device=dev)
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (1, 1536)),
        dtype=torch.int32, device=dev)

    def gen():
        g = torch.Generator(device=dev).manual_seed(1)
        return generate(cfg, model, prompts, max_new_tokens=16, generator=g,
                        top_k=64, top_p=0.9)

    port = list(blocks._BACKENDS)
    for label, backends in (("the port's backends", port),
                            ("with cuDNN's attention",
                             port + [SDPBackend.CUDNN_ATTENTION])):
        blocks._BACKENDS = backends
        try:
            runs = [gen() for _ in range(args.repeats)]
        finally:
            blocks._BACKENDS = port
        same = [bool(torch.equal(runs[0], r)) for r in runs]
        print(f"{card}: {label}: repeats equal to the first run: {same}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
