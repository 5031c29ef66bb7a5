"""The training step: loss, backward, an optional gradient hook, AdamW.

The port of ``repro/train/loop.py``'s single-replica half.  The train
state is ``{"model": the family's model (trainable), "opt": {"master",
"m", "v": dicts keyed by parameter name, "step": int32}}``, and a step
updates it in place.  Each layer's activations are recomputed in
backward, as the reference's ``jax.checkpoint`` bodies are, so a MoE
model's router (and its radix top-k) runs twice a layer a step.

``microbatches`` > 1 accumulates the grads of equal slices of the batch
in float32 and averages them, as the reference's ``lax.scan`` does; its
``"ce"`` metric is then the total loss (CE + aux), which is what the
reference reports there.  ``grad_reduce(grads, state) -> (grads,
extra)`` runs between backward and the optimizer, and ``extra`` is merged
into the state: the hook a data-parallel wrapper uses (ROADMAP Queue 1
item 4, with ``make_dp_train_step``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models import api
from .optimizer import adamw_init, adamw_update, cosine_lr

TrainState = Dict[str, Any]   # {"model": LM, "opt": {master, m, v, step}}


def init_state(cfg: ModelCfg, seed: int = 0, device="cuda") -> TrainState:
    """A trainable model drawn from ``seed`` on ``device``, and its AdamW
    slots."""
    model = api.init(cfg, seed=seed, device=device).trainable(True)
    return {"model": model, "opt": adamw_init(model.named_parameters())}


def _grads(cfg: ModelCfg, model, batch):
    """Loss, metrics and every parameter's gradient (zeros where the loss
    does not reach a parameter, as ``jax.grad`` gives)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    total, metrics = api.loss(cfg, model, batch)
    total.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
        grads


def _slice(batch, i: int, n: int):
    """The ``i``-th of ``n`` equal slices of every leaf's leading axis."""
    def one(a):
        a = torch.as_tensor(a)
        size = a.shape[0] // n
        return a[i * size:(i + 1) * size]
    return {k: one(v) for k, v in batch.items()}


def make_train_step(cfg: ModelCfg, *, peak_lr=3e-4, warmup=100,
                    total_steps=10_000, weight_decay=0.1, clip=1.0,
                    microbatches=1, grad_reduce=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are 0-d float32 tensors on the model's device: ``loss``, ``lr``,
    ``grad_norm`` and ``ce``."""

    def train_step(state: TrainState, batch):
        model = state["model"]
        if microbatches == 1:
            total, metrics, grads = _grads(cfg, model, batch)
        else:
            grads, total = None, 0.0
            for i in range(microbatches):
                loss_i, _, g = _grads(cfg, model,
                                      _slice(batch, i, microbatches))
                total = total + loss_i
                if grads is None:
                    grads = {n: t.float() for n, t in g.items()}
                else:
                    for n, t in g.items():
                        grads[n] += t.float()
            for g in grads.values():
                g /= microbatches
            total = total / microbatches
            metrics = {"ce": total}
        if grad_reduce is not None:
            grads, extra = grad_reduce(grads, state)
            state.update(extra)
        opt = state["opt"]
        lr = cosine_lr(opt["step"] + 1, peak=peak_lr, warmup=warmup,
                       total=total_steps).to(total.device)
        gnorm = adamw_update(dict(model.named_parameters()), grads, opt,
                             lr=lr, weight_decay=weight_decay, clip=clip)
        return state, {"loss": total, "lr": lr, "grad_norm": gnorm,
                       **metrics}

    return train_step
