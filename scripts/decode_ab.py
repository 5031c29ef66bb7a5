"""Model serving's decode step in this checkout against another's.

    python3 scripts/decode_ab.py --parent DIR [--archs A,B,...] [--rounds N]

Needs an NVIDIA card and nvcc (the sampler's and the router's radix
kernel).  ``DIR`` is another checkout of the repo, for example an
unpacked ``git archive`` of an earlier commit.  The two checkouts'
``repro_torch`` cannot share a process, so each side runs in its own, in
the order (parent, package, package, parent), ``--rounds`` times, so
that drift shows as a gap between a side's readings.  A process draws
each arch at its full config (bf16, seed 0) and runs ``serve.generate``
as ``chip_smoke.py`` phase 8 does (its batch, prompt, new tokens, top_k
and top_p; prompts from ``default_rng(0)``, generator seed 1): once to
build and warm up, then ``--reps`` times timed, a host-clock stamp at
every sample, each step synchronised.  It prints, per side and arch and
for each process, the median decode step and the median prompt time
(prefill, or the token-by-token warm-up), then the medians over the
side's processes; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
# phase 8's runs: (batch, prompt, new tokens, top_k, top_p)
RUNS = {"granite-moe-3b-a800m": (4, 128, 32, 16, 0.9),
        "gemma3-4b": (1, 1536, 16, 64, 0.9),
        "hymba-1.5b": (4, 64, 32, 16, 0.9),
        "rwkv6-1.6b": (8, 64, 32, 16, 0.9),
        "whisper-tiny": (4, 32, 32, 16, 0.9),
        "qwen2-vl-7b": (2, 256, 16, 64, 0.9)}


def worker(root: Path, archs, reps: int) -> dict:
    """Decode and prompt ms of each arch with ``root``'s package."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.serve import engine, generate
    dev = torch.device("cuda")
    out = {}
    for arch in archs:
        b, s, new, top_k, top_p = RUNS[arch]
        cfg = get_config(arch)
        model = api.init(cfg, seed=0, device=dev)
        prompts = torch.as_tensor(
            np.random.default_rng(0).integers(0, cfg.vocab, (b, s)),
            dtype=torch.int32, device=dev)
        frames = (torch.as_tensor(np.random.default_rng(1).normal(
            size=(b, cfg.enc_ctx, cfg.d_model)), dtype=torch.float32,
            device=dev) if cfg.family == "encdec" else None)

        def gen():
            g = torch.Generator(device=dev).manual_seed(1)
            return generate(cfg, model, prompts, max_new_tokens=new,
                            generator=g, top_k=top_k, top_p=top_p,
                            frames=frames)

        gen()
        prompt, steps = [], []
        sample = engine.sample
        for _ in range(reps):
            stamps = []

            def stamped(*a, **kw):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                return sample(*a, **kw)

            engine.sample = stamped
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                gen()
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
            finally:
                engine.sample = sample
            prompt.append((stamps[0] - t0) * 1e3)
            steps.extend(np.diff(stamps) * 1e3)
        out[arch] = {"prompt_ms": float(np.median(prompt)),
                     "decode_ms": float(np.median(steps))}
        del model
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--archs", default="granite-moe-3b-a800m,gemma3-4b,"
                    "rwkv6-1.6b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    archs = args.archs.split(",")
    if args.worker is not None:
        print(json.dumps(worker(args.worker, archs, args.reps)))
        return 0
    if args.parent is None:
        ap.error("--parent DIR is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    sides = {"package": ROOT, "parent": args.parent.resolve()}
    got = {"package": [], "parent": []}
    for side in ("parent", "package", "package", "parent") * args.rounds:
        run = subprocess.run([sys.executable, __file__, "--worker",
                              str(sides[side]), "--archs", args.archs,
                              "--reps", str(args.reps)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            return 1
        got[side].append(json.loads(run.stdout.strip().splitlines()[-1]))
    for arch in archs:
        for side in ("parent", "package"):
            ms = [r[arch] for r in got[side]]
            print(f"{card}: {arch} {side}: decode step "
                  + ", ".join(f"{m['decode_ms']:.3f}" for m in ms)
                  + " ms (median of the steps, each run); prompt "
                  + ", ".join(f"{m['prompt_ms']:.3f}" for m in ms) + " ms")
        for side in ("parent", "package"):
            ms = [r[arch] for r in got[side]]
            print(f"{card}: {arch} {side}: median of {len(ms)} processes: "
                  f"decode step {np.median([m['decode_ms'] for m in ms]):.3f}"
                  f" ms, prompt {np.median([m['prompt_ms'] for m in ms]):.3f}"
                  " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
