"""Mixed-precision AdamW: float32 master weights and moments beside the
model's compute parameters.

The port of ``repro/train/optimizer.py``.  The reference's update is
functional: it returns new moments, a new master and a float32 copy of
the grads, which at granite-moe-3b-a800m's 3.9 B parameters is some
58 GiB on top of the state.  Here the update runs in place, one leaf at
a time, in the reference's order of operations: the global norm of the
unclipped grads, the clip scale, ``m``, ``v``, the bias corrections, the
decoupled weight decay on every leaf (norms included, as there), the
master step, and the parameter as the master cast to its dtype.  The
slots are dicts keyed by the model's parameter names.
"""

from __future__ import annotations

import math

import torch


def cosine_lr(step, *, peak, warmup, total, floor=0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak`` at ``total``; float32, in the reference's
    order of operations.  ``step``: an int or an integer tensor."""
    step = torch.as_tensor(step, dtype=torch.int32).float()
    warm = peak * step / max(warmup, 1)
    t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, cos)


def adamw_init(params) -> dict:
    """Slots for ``params`` (a mapping of names to tensors): a float32
    master copy that never aliases the parameters (float32 ones
    included), zero moments ``m`` and ``v``, and ``step`` (int32, 0)."""
    params = dict(params)
    dev = next(iter(params.values())).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in params.items()},
        "m": {n: zeros(p) for n, p in params.items()},
        "v": {n: zeros(p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(grads) -> torch.Tensor:
    """The float32 L2 norm over every leaf of ``grads`` (a mapping)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


@torch.no_grad()
def adamw_update(params, grads, opt, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip=1.0, gnorm=None) -> torch.Tensor:
    """One AdamW step in place: ``opt``'s slots and ``step``, and each
    tensor of ``params`` (a mapping) set to its new master value in its
    own dtype.  ``grads`` maps every name of ``params`` to its gradient,
    in any float dtype.  ``lr``: a float or a 0-d tensor.  ``gnorm``, the
    global norm the clip reads, is ``global_norm(grads)`` unless given
    (a rank that holds some leaves in part).  Returns it."""
    opt["step"] += 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    step = opt["step"].float()
    c1 = 1 - b1 ** step
    c2 = 1 - b2 ** step
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v, master = opt["m"][name], opt["v"][name], opt["master"][name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        update = (m / c1) / (torch.sqrt(v / c2) + eps) \
            + weight_decay * master
        master.sub_(lr * update)
        p.copy_(master)
    return gnorm
