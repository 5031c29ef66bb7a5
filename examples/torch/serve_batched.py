"""Batched serving example on the PyTorch port: prefill + eager decode loop
with the radix top-k / top-p sampler (the twin of
``examples/serve_batched.py``).

Run:  PYTHONPATH=src python examples/torch/serve_batched.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import api
from repro_torch.serve import generate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = get_config("gemma3-4b", smoke=True)   # reduced gemma3 (windowed)
    model = api.init(cfg, seed=0, device=args.device)
    rng = np.random.default_rng(0)

    batch, prompt_len, new = 8, 16, 24
    prompts = torch.as_tensor(rng.integers(1, cfg.vocab, (batch, prompt_len)),
                              dtype=torch.int32, device=model.device)

    def gen(seed):
        out = generate(cfg, model, prompts, max_new_tokens=new,
                       generator=torch.Generator(model.device).manual_seed(
                           seed), temperature=0.8, top_k=32, top_p=0.9)
        return out.cpu()              # waits for the card where there is one

    t0 = time.perf_counter()
    out = gen(1)
    t1 = time.perf_counter()
    out2 = gen(2)
    t2 = time.perf_counter()

    print(f"batch={batch} prompt={prompt_len} new={new} on {model.device}")
    print(f"first run {t1 - t0:.2f}s; second {t2 - t1:.3f}s "
          f"({batch * new / (t2 - t1):.0f} tok/s)")
    o = out.numpy()
    assert ((o >= 0) & (o < cfg.vocab)).all()
    assert not torch.equal(out, out2), "different generator seeds must differ"
    print("sampled ids (first 2 rows):")
    print(o[:2])


if __name__ == "__main__":
    main()
