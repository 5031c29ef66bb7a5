"""A full-width granite-moe-3b-a800m train step with the MoE dispatch's and
the embedding's gradients as autograd's index gradient, and as the port's.

    python3 scripts/train_dispatch.py [--rounds 2]

Needs an NVIDIA card and nvcc (the router's radix kernel).  Draws
granite-moe-3b-a800m at its full config (bf16, seed 0) with its AdamW
slots, then times train steps (B = 2, S = 4,096, ``SyntheticCorpus``
seed 0; host clock, each step synchronised) in turns, index, rows, rows,
index, ``--rounds`` times:

  * ``index``: the dispatch gathers rows with plain indexing
    (``xf[stok]``, ``yf[slot]``, ``contrib[inv]``) and the embedding is
    ``embed[tokens]``, so backward accumulates each through autograd's
    sort-based index gradient;
  * ``rows``: the port's ``moe._Rows`` (a permutation's gradient written
    back row by row) and ``F.embedding`` (``transformer.embed_inputs``).

Each turn takes two steps and keeps the second.  A profiled step of each
prints the device time of the index gradient's kernel
(``indexing_backward_kernel``).  The card's name and power limit come
first; the medians and the spread last.
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


def _index_dispatch(cfg, p, xf, weights, expert_idx, e_lo, e_count, c):
    """``moe._dispatch_compute`` with plain indexing in place of
    ``moe._Rows`` (the port's dispatch before it)."""
    from repro_torch.models import moe
    from repro_torch.models.blocks import activation
    k = cfg.moe.top_k
    t, d = xf.shape
    tk = t * k
    dev = xf.device
    flat_e = expert_idx.reshape(tk).long()
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    flat_w = weights.reshape(tk).to(xf.dtype)
    order = torch.argsort(flat_e, stable=True)
    se, stok, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = moe._counts(flat_e, moe.padded_experts(cfg))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(tk, device=dev) - offsets[se]
    local = (se >= e_lo) & (se < e_lo + e_count)
    keep = (rank < c) & local
    slot = torch.where(keep, (se - e_lo) * c + rank, e_count * c)
    buf = xf.new_zeros((e_count * c + 1, d))
    buf[slot] = xf[stok] * keep[:, None].to(xf.dtype)
    buf = buf[:-1].reshape(e_count, c, d)
    act = activation(cfg)
    h = act(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    y = torch.bmm(h, p["down"])
    yf = torch.cat([y.reshape(e_count * c, d), y.new_zeros((1, d))])
    contrib = yf[slot] * sw[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(tk, device=dev)
    return contrib[inv].reshape(t, k, d).sum(1)


def _index_embed_inputs(cfg, model, batch):
    """``transformer.embed_inputs`` for a text batch of a RoPE model, with
    ``embed[tokens]`` in place of ``F.embedding``."""
    from repro_torch.models.blocks import dtype_of
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    x = model.embed[tokens].to(dtype_of(cfg))
    b, s = x.shape[:2]
    return x, torch.arange(s, device=model.device).expand(b, s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticCorpus
    from repro_torch.launch.train import make_batch
    from repro_torch.models import moe, transformer
    from repro_torch.train import init_state, make_train_step
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    cfg = get_config("granite-moe-3b-a800m")
    state = init_state(cfg, seed=0, device="cuda")
    step = make_train_step(cfg, total_steps=100)
    data = SyntheticCorpus(cfg.vocab, 4096, 2, seed=0)
    versions = {
        "index": ((moe, "_dispatch_compute", _index_dispatch),
                  (transformer, "embed_inputs", _index_embed_inputs)),
        "rows": ((moe, "_dispatch_compute", moe._dispatch_compute),
                 (transformer, "embed_inputs", transformer.embed_inputs)),
    }
    saved = [(m, n, getattr(m, n)) for m, n, _ in versions["index"]]
    i = 0

    def run(name, profiled=False):
        nonlocal i
        for m, n, v in versions[name]:
            setattr(m, n, v)
        try:
            ms = 0.0
            for _ in range(2):
                batch = make_batch(cfg, data.batch(i)["tokens"], "cuda")
                i += 1
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if profiled:
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        _, m_ = step(state, batch)
                        torch.cuda.synchronize()
                else:
                    _, m_ = step(state, batch)
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                if not np.isfinite(float(m_["loss"])):
                    raise RuntimeError(f"{name}: loss not finite")
        finally:
            for m, n, v in saved:
                setattr(m, n, v)
        if profiled:
            ev = [e for e in prof.events()
                  if "indexing_backward_kernel" in e.name]
            busy = sum(e.time_range.elapsed_us() for e in prof.events()
                       if str(e.device_type).endswith("CUDA")) / 1e3
            print(f"{card}: {name}: indexing_backward_kernel "
                  f"{sum(e.time_range.elapsed_us() for e in ev) / 1e3:.3f} "
                  f"ms in {len(ev)} launches of {busy:.3f} ms of kernels "
                  "(profiled step)")
        return ms

    times = {"index": [], "rows": []}
    for _ in range(args.rounds):
        for name in ("index", "rows", "rows", "index"):
            times[name].append(run(name))
    for name in ("index", "rows"):
        run(name, profiled=True)
    for name, ts in times.items():
        q1, q3 = np.percentile(ts, [25, 75])
        print(f"{card}: {name}: train step {np.median(ts):.3f} ms median "
              f"of {len(ts)} (quartiles {q1:.3f}, {q3:.3f}; all "
              f"{', '.join(f'{t:.3f}' for t in ts)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
