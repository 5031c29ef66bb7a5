"""End-to-end training on the PyTorch port: a MoE LM with the radix top-k
router, AdamW, the deterministic data pipeline and checkpoint/resume
(the twin of ``examples/train_end_to_end.py``).

Default arguments are the reduced granite-moe config (CPU-runnable with
``--device cpu``); ``--full100m --steps 300`` is the ~100M-parameter
variant for the card.

Run:  PYTHONPATH=src python examples/torch/train_end_to_end.py \\
          [--steps N] [--device cpu] [--ckpt DIR]
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import MoECfg
from repro_torch.data import SyntheticCorpus
from repro_torch.train.loop import init_state, make_train_step


def build_cfg(full100m: bool):
    base = get_config("granite-moe-3b-a800m", smoke=True)
    if not full100m:
        return base
    # ~100M active params: 8 layers, d=512, 16 experts top-4
    return dataclasses.replace(
        base, n_layers=8, d_model=512, n_heads=8, n_kv=4, d_head=64,
        d_ff=1024, vocab=32000,
        moe=MoECfg(n_experts=16, top_k=4, d_expert=1024))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full100m", action="store_true")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (default: a fresh temporary "
                    "one)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = build_cfg(args.full100m)
    print(f"config: {cfg.n_layers}L d={cfg.d_model} "
          f"experts={cfg.moe.n_experts} top{cfg.moe.top_k} "
          f"params~{cfg.param_count() / 1e6:.1f}M "
          f"(active {cfg.active_param_count() / 1e6:.1f}M)")

    data = SyntheticCorpus(cfg.vocab, args.seq, args.batch, seed=0)
    step = make_train_step(cfg, peak_lr=3e-3, warmup=10,
                           total_steps=args.steps)
    state = init_state(cfg, seed=0, device=args.device)
    dev = state["model"].device
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(args.ckpt or tmp)
        start = mgr.latest_step() or 0
        if start:
            state = mgr.restore(start, state)
            print(f"resumed at step {start}")

        first = last = None
        for i in range(start, args.steps):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in data.batch(i).items()}
            state, m = step(state, batch)
            loss = float(m["loss"])
            first = loss if first is None else first
            last = loss
            if (i + 1) % 10 == 0 or i == start:
                print(f"step {i + 1:4d} loss {loss:.4f} "
                      f"lr {float(m['lr']):.2e}")
                mgr.save(i + 1, state)
        mgr.wait()
    if first is None:
        print(f"step {start} reached already: no step to run")
        return
    print(f"loss {first:.4f} -> {last:.4f} over {args.steps - start} steps "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    if not last < first:
        raise RuntimeError("training did not reduce loss")


if __name__ == "__main__":
    main()
