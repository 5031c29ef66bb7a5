"""Serving launcher: batched generation with the radix sampler.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

The twin of ``repro.launch.serve``, for every arch.  Prompts come from
``np.random.default_rng(0)`` as there, and an encoder-decoder's frames are
zeros as there; weights from a ``torch.Generator`` seeded with 0 and
sampling from one seeded with 1.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import api
from repro_torch.serve import generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="hymba-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt_len", type=int, default=16)
    ap.add_argument("--new_tokens", type=int, default=16)
    ap.add_argument("--top_k", type=int, default=16)
    ap.add_argument("--top_p", type=float, default=0.9)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu "
                    "(the plain torch versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    model = api.init(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=model.device)
    frames = (torch.zeros((args.batch, cfg.enc_ctx, cfg.d_model),
                          device=model.device)
              if cfg.family == "encdec" else None)
    gen = torch.Generator(device=model.device).manual_seed(1)

    t0 = time.perf_counter()
    out = generate(cfg, model, prompts, max_new_tokens=args.new_tokens,
                   generator=gen, top_k=args.top_k, top_p=args.top_p,
                   frames=frames)
    if out.is_cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tok_s = args.batch * args.new_tokens / dt
    print(f"{args.arch}: generated {tuple(out.shape)} on {out.device} in "
          f"{dt:.2f}s "
          f"({tok_s:.1f} tok/s incl. first-call set-up)")
    o = out.cpu().numpy()
    if not ((o >= 0) & (o < cfg.vocab)).all():
        raise RuntimeError("sampled ids out of range")
    print(o[:2])
    return out


if __name__ == "__main__":
    main()
