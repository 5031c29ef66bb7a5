"""The granite cell's ``logit_gap`` on the card: the bf16 port, its expert
weights through float8, and every weight through float8.

    python3 scripts/granite_logit_gap.py [--seeds 2147483659,2147483660]

Needs an NVIDIA card and nvcc (the radix kernel).  For each seed, builds
the benchmark's program (``perfbench/programs/graniteserve.py``) at the
published ``granite-3.0-3b-a800m`` configuration three times: as it is,
with the expert weights rounded through ``float8_e4m3fn``, and with every
weight so rounded.  Each makes two ``generate`` calls of 64 prompts of 512
uniform ids and 32 new tokens, keeping 16 rows a call, and holds the kept
logits to the float32 reference (``perfbench/reference/granite_moe.py``,
teacher-forced on the generated ids) as the check does: a position's gap
is max |port - reference| over the reference's RMS there, and the check's
number is the median over the window's positions.  Prints each seed's
median and largest position gaps, and the median of every 16 rows'
positions (a 30-s window keeps about 15 rows).  The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

B, S, G = 64, 512, 32
ROWS = list(range(0, B, 4))
MODES = ("bf16", "fp8_experts", "fp8_all")


def gaps(config, server, seed, prompts, gen):
    from perfbench.reference.granite_moe import Weights, forward
    ids, kept = server.generate(prompts, G, gen, ROWS)
    seqs = torch.cat([prompts[ROWS], ids[ROWS].long()], 1)
    out = []
    for i in range(0, len(ROWS), 8):
        want = forward(config, Weights(config, seed, server.device),
                       seqs[i:i + 8], S - 1)[:, :G + 1]
        out.append((kept[i:i + 8] - want).abs().amax(-1)
                   / want.pow(2).mean(-1).sqrt())
    return torch.cat(out)                    # (rows, G + 1)


def round_all_fp8(server) -> None:
    with torch.no_grad():
        for p in server.model.parameters():
            p.copy_(p.to(torch.float8_e4m3fn).to(p.dtype))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="2147483659,2147483660,2147483661,"
                                       "2147483662")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from perfbench.programs import graniteserve
    config = json.loads((ROOT / "perfbench" / "configs" /
                         "granite-3.0-3b-a800m.json").read_text())
    found: dict = {m: [] for m in MODES}
    for seed in (int(s) for s in args.seeds.split(",")):
        server = graniteserve.build(config, "cuda", None)
        for mode in MODES:
            server.start(seed)
            if mode == "fp8_experts":
                graniteserve.control(server, config)    # the check's control
            elif mode == "fp8_all":
                round_all_fp8(server)
            gp = torch.Generator(device="cuda").manual_seed(seed)
            gs = torch.Generator(device="cuda").manual_seed(seed + 1)
            g = torch.cat([gaps(config, server, seed, torch.randint(
                0, config["vocab_size"], (B, S), generator=gp,
                device="cuda"), gs) for _ in range(2)])
            print(f"seed {seed} {mode:12s} median {g.median().item():.4f} "
                  f"max {g.max().item():.4f}", flush=True)
            found[mode].append(g.cpu())
            server.model = None
            torch.cuda.empty_cache()
    for mode, g in found.items():
        runs = torch.cat(g).reshape(-1, 16 * (G + 1)).median(-1).values
        print(mode, "median of every 16 rows:",
              [round(x, 4) for x in runs.tolist()])
    return 0


if __name__ == "__main__":
    sys.exit(main())
