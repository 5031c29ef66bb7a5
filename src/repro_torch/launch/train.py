"""Training launcher: the end-to-end loop with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-4b \\
        --smoke --steps 50 --ckpt_dir /tmp/ckpt [--resume] --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --batch 2 --seq 4096 --steps 4

The twin of ``repro.launch.train``: a deterministic data pipeline (resume
equals a run never stopped), auto-resume from the latest checkpoint, and
a checkpoint flushed on SIGTERM before a clean exit.  Weights come from a
``torch.Generator`` seeded with ``--seed``, batches from
``SyntheticCorpus`` with the same seed; an encoder-decoder's frames and a
VLM's patches are zeros, as there.  ``--microbatches`` splits each batch
for gradient accumulation.  A ``--resume`` whose latest checkpoint is
already at ``--steps`` has no step to run: it saves nothing and exits
(the reference stops there with a NameError).
"""

from __future__ import annotations

import argparse
import signal
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import SyntheticCorpus
from repro_torch.train.loop import init_state, make_train_step


def make_batch(cfg, tokens, device) -> dict:
    """The model inputs of a token batch: zero frames for an
    encoder-decoder; zero patches and 1-D positions on all three M-RoPE
    streams for a VLM."""
    batch = {"tokens": torch.as_tensor(tokens, device=device)}
    b, s = batch["tokens"].shape
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((b, cfg.enc_ctx, cfg.d_model),
                                      device=device)
    if cfg.family == "vlm":
        p = cfg.vision_patches
        batch["patches"] = torch.zeros((b, p, cfg.d_model), device=device)
        pos1 = torch.arange(s + p, dtype=torch.int32, device=device)
        batch["positions3"] = pos1[None, :, None].expand(b, s + p, 3)
    return batch


def main(argv=None):
    """Returns the last step's loss (None when no step ran)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCHS, default="gemma3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt_dir", default="")
    ap.add_argument("--ckpt_every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default; raises without a card) or cpu "
                    "(the plain torch versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    data = SyntheticCorpus(cfg.vocab, args.seq, args.batch, seed=args.seed)
    step_fn = make_train_step(cfg, total_steps=args.steps,
                              microbatches=args.microbatches)
    state = init_state(cfg, seed=args.seed, device=args.device)
    dev = state["model"].device
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        latest = mgr.latest_step()
        if args.resume and latest is not None:
            state = mgr.restore(latest, state)
            start = latest
            print(f"resumed from step {latest}")
    if start >= args.steps:
        print(f"step {start} reached already: no step to run")
        return None

    stop = {"flag": False}
    previous = signal.signal(signal.SIGTERM,
                             lambda *_: stop.update(flag=True))
    try:
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = make_batch(cfg, data.batch(step)["tokens"], dev)
            state, metrics = step_fn(state, batch)
            if mgr and ((step + 1) % args.ckpt_every == 0 or stop["flag"]):
                mgr.save(step + 1, state)
            loss = float(metrics["loss"])
            print(f"step {step + 1} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={time.perf_counter() - t0:.2f}s", flush=True)
            if stop["flag"]:
                print("preempted: checkpoint flushed, exiting cleanly")
                break
        if mgr:
            mgr.save(step + 1, state, blocking=True)
    finally:
        signal.signal(signal.SIGTERM, previous)
    return loss


if __name__ == "__main__":
    main()
