"""The port's training objective against the JAX reference, all ten archs.

The reference's ``api.init`` tree goes through ``convert.from_reference``
into the port, the model is made trainable, and the same numpy-seeded
batch (``tests/test_arch_smoke.py``'s: B = 2, S = 32, normal frames and
patches) goes through ``api.loss`` and its gradient in both packages on
the CPU, at smoke size in float32:

  * the loss and its ``ce`` within ``LOSS_TOL``, and every grad leaf,
    stacked back into the reference's tree by ``convert.to_reference``,
    within ``GRAD_REL`` of that leaf's largest magnitude;
  * the reference's two properties of a train step: everything finite,
    more than half the grads nonzero;
  * the MoE router learns only through the aux loss: its gradient from
    the CE alone is zero in the port, and from the whole loss it equals
    the reference's gradient of ``0.01 * aux`` alone;
  * remat changes no number, and recomputes each router call once.

Tolerances: the packages order their float32 sums differently (the
largest difference seen is 1.4e-6 on losses near 6, and 3e-6 of a
leaf's largest gradient); the bounds are about 10 times that.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.models import api as ref_api
from repro.models import transformer as ref_transformer
from repro_torch.configs import get_config
from repro_torch.models import api, convert, moe

LOSS_TOL = dict(rtol=2e-6, atol=1e-5)
GRAD_REL = 2e-5


def batch_for(cfg, b=2, s=32):
    """tests/test_arch_smoke.py's batch, as numpy arrays."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.enc_ctx, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        p = cfg.vision_patches
        batch["tokens"] = batch["tokens"][:, : s - p]
        batch["patches"] = rng.normal(
            size=(b, p, cfg.d_model)).astype(np.float32)
        pos1 = np.broadcast_to(np.arange(s), (b, s))
        batch["positions3"] = np.stack([pos1] * 3, -1).astype(np.int32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def reference_grads(arch, batch, seed=0):
    rcfg = ref_config(arch, smoke=True)
    params = ref_api.init(rcfg, jax.random.key(seed))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, metrics), grads = jax.value_and_grad(
        lambda p: ref_api.loss(rcfg, p, jb), has_aux=True)(params)
    return (jax.tree.map(np.asarray, params), float(total),
            float(metrics["ce"]), jax.tree.map(np.asarray, grads))


def port_grads(cfg, model, batch):
    for p in model.parameters():
        p.grad = None
    total, metrics = api.loss(cfg, model, torch_batch(batch))
    total.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    return float(total.detach()), float(metrics["ce"].detach()), grads


def leaves(tree):
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def assert_grads_close(got_tree, want_tree):
    got, want = leaves(got_tree), leaves(want_tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, key
        bound = GRAD_REL * np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= bound, f"{key}: {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg = get_config(arch, smoke=True)
    batch = batch_for(cfg)
    params, want_total, want_ce, want_grads = reference_grads(arch, batch)
    model = convert.from_reference(cfg, params, device="cpu")
    total, ce, grads = port_grads(cfg, model.trainable(True), batch)
    np.testing.assert_allclose(total, want_total, **LOSS_TOL)
    np.testing.assert_allclose(ce, want_ce, **LOSS_TOL)
    assert_grads_close(convert.to_reference(cfg, grads), want_grads)
    # tests/test_arch_smoke.py's properties, in the port
    assert np.isfinite(total) and np.isfinite(ce)
    assert all(torch.isfinite(g).all() for g in grads.values())
    nz = sum(float(g.abs().sum()) > 0 for g in grads.values())
    # per port leaf: a stacked reference leaf counts each layer here
    assert nz > len(grads) * 0.5, f"{arch}: {nz}/{len(grads)} nonzero"


def test_models_are_built_frozen_and_serve_without_grad():
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    model = api.init(cfg, seed=0, device="cpu")
    assert not any(p.requires_grad for p in model.parameters())
    assert model.trainable(True) is model
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    logits, _ = api.prefill(cfg, model, {"tokens": tokens})
    assert not logits.requires_grad
    model.trainable(False)
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-235b-a22b"])
def test_router_learns_only_through_the_aux_loss(arch):
    cfg = get_config(arch, smoke=True)
    rcfg = ref_config(arch, smoke=True)
    batch = batch_for(cfg)
    params, _, _, want_grads = reference_grads(arch, batch)
    # the reference: the gradient of 0.01 * aux alone
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    aux_grads = jax.grad(lambda p: 0.01 * ref_transformer.forward(
        rcfg, p, jb)[1])(jax.tree.map(jnp.asarray, params))
    want_aux = np.asarray(aux_grads["layers"]["moe"]["router"])
    np.testing.assert_allclose(
        want_grads["layers"]["moe"]["router"], want_aux, rtol=1e-5,
        atol=1e-7)
    model = convert.from_reference(cfg, params, device="cpu").trainable(True)
    _, _, grads = port_grads(cfg, model, batch)
    got = np.stack([grads[f"blocks.{i}.moe.router"].numpy()
                    for i in range(cfg.n_layers)])
    assert np.abs(got).max() > 0
    bound = GRAD_REL * np.abs(want_aux).max()
    assert np.abs(got - want_aux).max() <= bound
    # the CE alone reaches no router weight
    for p in model.parameters():
        p.grad = None
    api.loss(cfg, model, torch_batch(batch))[1]["ce"].backward()
    for i in range(cfg.n_layers):
        g = model.blocks[i].moe["router"].grad
        assert g is None or not g.any()


def test_router_through_torch_topk_keeps_its_gate_gradient():
    """With ``router_use_radix=False`` the gate values come from
    ``torch.topk`` and carry gradient, as ``lax.top_k``'s do."""
    arch = "granite-moe-3b-a800m"
    cfg = get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, router_use_radix=False))
    rcfg = ref_config(arch, smoke=True)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, router_use_radix=False))
    batch = batch_for(cfg)
    params = ref_api.init(rcfg, jax.random.key(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.grad(lambda p: ref_api.loss(rcfg, p, jb)[1]["ce"])(params)
    want = np.asarray(want["layers"]["moe"]["router"])
    model = convert.from_reference(
        cfg, jax.tree.map(np.asarray, params), device="cpu").trainable(True)
    api.loss(cfg, model, torch_batch(batch))[1]["ce"].backward()
    got = np.stack([model.blocks[i].moe["router"].grad.numpy()
                    for i in range(cfg.n_layers)])
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= GRAD_REL * np.abs(want).max()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "rwkv6-1.6b",
                                  "whisper-tiny"])
def test_remat_changes_no_number(arch, monkeypatch):
    cfg = get_config(arch, smoke=True)
    batch = batch_for(cfg)
    model = api.init(cfg, seed=3, device="cpu").trainable(True)
    calls = []
    route = moe.radix_topk

    def counted(*a, **kw):
        calls.append(1)
        return route(*a, **kw)

    monkeypatch.setattr(moe, "radix_topk", counted)
    family = api._family_mod(cfg)
    forward = family.forward
    out = {}
    for remat in (True, False):
        calls.clear()
        # api.loss calls the family's forward, here with remat as given
        monkeypatch.setattr(family, "forward",
                            functools.partial(forward, remat=remat))
        total, ce, grads = port_grads(cfg, model, batch)
        out[remat] = (total, {n: g.clone() for n, g in grads.items()})
        # each layer's router runs once, and again in its recompute
        routers = cfg.n_layers if cfg.moe is not None else 0
        assert len(calls) == routers * (2 if remat else 1)
    assert out[True][0] == out[False][0]
    for n, g in out[True][1].items():
        assert torch.equal(g, out[False][1][n]), n


def _plain_dispatch(cfg, p, xf, weights, expert_idx, c):
    """The dispatch with autograd's own index gradients (the port's code
    before ``moe._Rows``)."""
    k = cfg.moe.top_k
    t, d = xf.shape
    tk = t * k
    e_count = moe.padded_experts(cfg)
    flat_e = expert_idx.reshape(tk).long()
    flat_t = torch.arange(t).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, stok = flat_e[order], flat_t[order]
    sw = weights.reshape(tk).to(xf.dtype)[order]
    counts = torch.bincount(flat_e, minlength=e_count)
    rank = torch.arange(tk) - (torch.cumsum(counts, 0) - counts)[se]
    keep = rank < c
    slot = torch.where(keep, se * c + rank, e_count * c)
    buf = xf.new_zeros((e_count * c + 1, d))
    buf[slot] = xf[stok] * keep[:, None].to(xf.dtype)
    buf = buf[:-1].reshape(e_count, c, d)
    act = torch.nn.functional.silu
    h = act(torch.bmm(buf, p["gate"])) * torch.bmm(buf, p["up"])
    y = torch.bmm(h, p["down"])
    yf = torch.cat([y.reshape(e_count * c, d), y.new_zeros((1, d))])
    contrib = yf[slot] * sw[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(tk)
    return contrib[inv].reshape(t, k, d).sum(1)


def test_dispatch_gradient_equals_plain_indexing():
    """The dispatch's row gathers (``moe._Rows``) give the gradient of
    plain indexing, with a capacity of 4 that drops most entries onto the
    spare row (float32; the sums over a token's choices run in another
    order, so within 1e-6)."""
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    model = api.init(cfg, seed=4, device="cpu").trainable(True)
    p = model.blocks[0].moe
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn((64, cfg.d_model), generator=g)
    weights, idx, _ = moe._route(cfg, p["router"], x0)
    r = torch.randn((64, cfg.d_model), generator=g)
    grads = []
    for fn in (lambda x: moe._dispatch_compute(
            cfg, p, x, weights, idx, 0, moe.padded_experts(cfg), 4),
               lambda x: _plain_dispatch(cfg, p, x, weights, idx, 4)):
        x = x0.clone().requires_grad_(True)
        for t in p.values():
            t.grad = None
        out = fn(x)
        (out * r).sum().backward()
        grads.append([out.detach(), x.grad] + [p[n].grad for n in
                                               ("gate", "up", "down")])
    assert grads[0][0].abs().max() > 0
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
