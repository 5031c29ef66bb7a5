"""The training step: loss, backward, an optional gradient hook, AdamW.

The port of ``repro/train/loop.py``.  Two step builders:

  * :func:`make_train_step`, one replica's step, with the ``grad_reduce``
    hook a wrapper uses to intercept the grads before the optimizer;
  * :func:`make_dp_train_step`, data parallelism over a mesh axis, each
    rank a replica: the grads are ``pmean``-ed, or go through the
    error-feedback top-k compressed all-reduce
    (:func:`repro_torch.dist.compress.ef_topk_psum_tree`), whose global
    threshold is the paper's §IV multi-bank search; the residuals stay on
    their rank in the ``"ef"`` slot of its state.  On a mesh with a
    ``model`` axis of more than one rank the MoE layers also run expert
    parallel, each rank holding only its experts: the reference's
    ``make_train_step(cfg, act_specs=act_specs(mesh))`` under its mesh.

The state is ``{"model": the family's model (trainable), "opt": {"master",
"m", "v": dicts keyed by parameter name, "step": int32}}``, and a step
updates it in place.  Each layer's activations are recomputed in
backward, as the reference's ``jax.checkpoint`` bodies are, so a MoE
model's router (and its radix top-k) runs twice a layer a step.

``microbatches`` > 1 accumulates the grads of equal slices of the batch
in float32 and averages them, as the reference's ``lax.scan`` does; its
``"ce"`` metric is then the total loss (CE + aux), which is what the
reference reports there.  ``grad_reduce(grads, state) -> (grads,
extra)`` runs between backward and the optimizer, and ``extra`` is merged
into the state: the hook :func:`make_dp_train_step` plugs into.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.dist._comm import axis_index, axis_size, pmean, psum
from repro_torch.dist.compress import ef_topk_psum_tree
from repro_torch.dist.sharding import act_specs as mesh_act_specs
from repro_torch.dist.sharding import stacked_shapes
from repro_torch.models import api, moe
from repro_torch.models.convert import stack_layers, unstack_layers
from .optimizer import adamw_init, adamw_update, cosine_lr

TrainState = Dict[str, Any]   # {"model": LM, "opt": {master, m, v, step}}


def init_state(cfg: ModelCfg, seed: int = 0, device="cuda") -> TrainState:
    """A trainable model drawn from ``seed`` on ``device``, and its AdamW
    slots."""
    model = api.init(cfg, seed=seed, device=device).trainable(True)
    return {"model": model, "opt": adamw_init(model.named_parameters())}


def _grads(cfg: ModelCfg, model, batch, act_specs=None):
    """Loss, metrics and every parameter's gradient (zeros where the loss
    does not reach a parameter, as ``jax.grad`` gives)."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    total, metrics = api.loss(cfg, model, batch, act_specs=act_specs)
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


def make_train_step(cfg: ModelCfg, *, act_specs=None, peak_lr=3e-4,
                    warmup=100, total_steps=10_000, weight_decay=0.1,
                    clip=1.0, microbatches=1, grad_reduce=None,
                    grad_norm=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are 0-d float32 tensors on the model's device: ``loss``, ``lr``,
    ``grad_norm`` and ``ce``.  ``act_specs`` goes to the loss (a mesh with
    a ``model`` axis runs the MoE layers expert parallel);
    ``grad_norm(grads)`` gives the norm the clip reads when a rank holds
    some leaves in part."""

    def train_step(state: TrainState, batch):
        model = state["model"]
        if microbatches == 1:
            total, metrics, grads = _grads(cfg, model, batch, act_specs)
        else:
            grads, total = None, 0.0
            for i in range(microbatches):
                loss_i, _, g = _grads(cfg, model,
                                      _slice(batch, i, microbatches),
                                      act_specs)
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
                             lr=lr, weight_decay=weight_decay, clip=clip,
                             gnorm=grad_norm(grads) if grad_norm else None)
        return state, {"loss": total, "lr": lr, "grad_norm": gnorm,
                       **metrics}

    return train_step


# ------------------------------------------------ explicit data parallelism

def init_dp_state(cfg: ModelCfg, seed: int, mesh, *, axis_name="data",
                  compress: bool = False) -> TrainState:
    """This rank's train state for :func:`make_dp_train_step`: the replica
    drawn from ``seed`` (the same on every rank) on the mesh's device.
    With ``compress=True`` the state carries an ``"ef"`` dict of this
    rank's float32 error-feedback residuals, zeros, one for each of the
    reference's leaves (``convert.stack_layers``: the layers stacked, so
    a leaf's top-k runs over all its layers, as the reference's does).
    On a mesh with a ``model`` axis of more than one rank the model keeps
    only this rank's experts (:func:`~repro_torch.models.moe.shard_experts`)
    and the optimizer only their slots."""
    state = init_state(cfg, seed=seed, device=mesh.device)
    if _expert_parallel(cfg, mesh):
        if compress:
            raise ValueError("the compressed all-reduce takes replicated "
                             "leaves: no expert-parallel mesh")
        moe.shard_experts(cfg, state["model"], mesh)
        state["opt"] = adamw_init(state["model"].named_parameters())
    if compress:
        state["ef"] = {path: torch.zeros(shape, dtype=torch.float32,
                                         device=mesh.device)
                       for path, (shape, _) in
                       stacked_shapes(state["model"]).items()}
    return state


def make_dp_train_step(cfg: ModelCfg, mesh, *, axis_name="data",
                       compress_ratio: float | None = None, **kw):
    """Data parallelism over ``mesh[axis_name]``: returns ``step(state,
    batch) -> (state, metrics)``, run on every rank with the *global*
    batch, of which each rank takes its slice (the leading axis split in
    axis-index order).  Params and optimizer stay replicated: the grads
    are ``pmean``-ed, each in its own dtype as the reference's are, before
    the optimizer, or, with ``compress_ratio``, reduced by
    :func:`~repro_torch.dist.compress.ef_topk_psum_tree` (in the
    residual's float32) and divided by the axis size.
    ``compress_ratio=1.0`` selects everything: the plain ``pmean`` step,
    within the sum's order, for float32 leaves; a bf16 leaf's plain mean
    rounds each partial sum where the compressed one rounds once.  The
    metrics are ``pmean``-ed.  ``kw`` goes to :func:`make_train_step`.
    Build the state with :func:`init_dp_state`.

    With a ``model`` axis of more than one rank (a MoE config) the step
    is expert parallel: the loss gets the mesh's ``act_specs``, each
    rank's grads are those of its data shard (its experts' in full, the
    rest the same on every model rank), the ``pmean`` over ``axis_name``
    averages them, and the clip reads the global norm, the expert
    leaves' squares summed over ``model``."""
    n = axis_size(mesh, axis_name)
    if _expert_parallel(cfg, mesh):
        if compress_ratio is not None:
            raise ValueError("the compressed all-reduce takes replicated "
                             "leaves: no expert-parallel mesh")
        kw = {"act_specs": mesh_act_specs(mesh),
              "grad_norm": lambda grads: _ep_norm(grads, mesh), **kw}

    def grad_reduce(grads, state):
        if compress_ratio is None:
            return {k: pmean(g, mesh, axis_name)
                    for k, g in grads.items()}, {}
        red, err = ef_topk_psum_tree(stack_layers(grads), state["ef"], mesh,
                                     ratio=compress_ratio,
                                     axis_name=axis_name)
        red = {k: r / n for k, r in red.items()}
        return unstack_layers(red, grads), {"ef": err}

    inner = make_train_step(cfg, grad_reduce=grad_reduce, **kw)

    def step(state, batch):
        local = _slice(batch, axis_index(mesh, axis_name), n)
        state, metrics = inner(state, local)
        return state, {k: pmean(v, mesh, axis_name)
                       for k, v in metrics.items()}

    return step


def _expert_parallel(cfg: ModelCfg, mesh) -> bool:
    return (cfg.moe is not None and "model" in mesh.axis_names
            and mesh.shape["model"] > 1)


def _ep_norm(grads, mesh) -> torch.Tensor:
    """The global norm of an expert-parallel rank's grads: the expert
    leaves' squares summed over ``model`` (one collective), the rest,
    the same on every model rank, counted once."""
    sq = {True: 0.0, False: 0.0}
    for name, g in grads.items():
        sq[moe.is_expert_leaf(name)] += torch.sum(torch.square(g.float()))
    experts = torch.as_tensor(sq[True], dtype=torch.float32,
                              device=mesh.device)
    return torch.sqrt(sq[False] + psum(experts, mesh, "model"))
