"""Rank bodies of the port's distribution tests (imports no jax).

Each ``case_*`` runs on every rank of a group started by
``repro_torch.launch.mesh.spawn`` and returns this rank's results as numpy
arrays; the tests hold them against the JAX package (on the CPU) or the
port's one-rank functions and numpy (on the card).  Run as a script to
start the ranks in a process of their own:

    python tests/_torch_dist_ranks.py CASE DIR

reads ``DIR/in.pkl`` (the case's inputs, numpy) and writes
``DIR/port.pkl`` (a list of the ranks' results, in rank order).
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from repro_torch.dist import _comm  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh, spawn  # noqa: E402

WORLD = {"distsort": 8, "compress": 4, "dp_train": 4, "moe_ep": 8,
         "ep_train": 4, "bankmesh": 4}


def _t(a, dev):
    return torch.as_tensor(np.asarray(a), device=dev)


def _np(t):
    return t.detach().cpu().numpy()


def _cols(a, i, n):
    """Bank ``i`` of ``n``: its contiguous share of the trailing axis."""
    w = a.shape[-1] // n
    return a[..., i * w:(i + 1) * w]


def _setup():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- distsort

def case_distsort(rank, inp, device):
    """The reference's ``test_distsort.py`` cases: 8 banks (and the same
    8 as a tuple of two axes), then 4 banks on every trial."""
    from repro_torch.core.distsort import (global_min_sharded,
                                           kth_largest_sharded,
                                           topk_mask_sharded)
    from repro_torch.core.topk import to_sortable_uint
    _setup()
    mesh8 = make_mesh((8,), ("banks",), device=device)
    mesh4 = make_mesh((2, 4), ("rep", "banks"), device=device)
    dev = mesh8.device
    out = {}
    b8 = _comm.axis_index(mesh8, "banks")
    for name in ("x", "ties"):
        xl = _t(_cols(inp[name], b8, 8), dev)
        out[f"{name}_mask8"] = _np(topk_mask_sharded(xl, 13, mesh8, "banks"))
        # the same eight banks as the tuple ("rep", "banks") of a 2 x 4 mesh
        bt = _comm.axis_index(mesh4, ("rep", "banks"))
        xt = _t(_cols(inp[name], bt, 8), dev)
        out[f"{name}_mask8t"] = _np(topk_mask_sharded(
            xt, 13, mesh4, ("rep", "banks")))
    u = to_sortable_uint(_t(_cols(inp["ties"], b8, 8), dev))
    out["ties_min8"] = _np(global_min_sharded(u, mesh8, "banks"))
    b4 = _comm.axis_index(mesh4, "banks")
    for j, (u, ks) in enumerate(zip(inp["trials"], inp["trial_ks"])):
        ul = _t(_cols(u.astype(np.int64), b4, 4), dev)
        for k in ks:
            out[f"t{j}_kth{k}"] = _np(kth_largest_sharded(ul, int(k), mesh4,
                                                          "banks"))
        out[f"t{j}_min"] = _np(global_min_sharded(ul, mesh4, "banks"))
        # uint32 words, as the reference's test passes them
        out[f"t{j}_mask5"] = _np(topk_mask_sharded(
            _t(_cols(u, b4, 4), dev), min(5, u.shape[-1]), mesh4, "banks"))
    out["collectives"] = _comm.collectives
    return out


# ---------------------------------------------------------------- compress

def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def case_compress(rank, inp, device):
    """``ef_topk_psum``, ``_auto`` and ``_tree`` on 4 ranks (the
    reference's ``test_dist_features.py`` inputs and a tree), the
    pipeline against its stages one after another, and the mesh
    builders."""
    from repro_torch.dist.compress import (ef_topk_psum, ef_topk_psum_auto,
                                           ef_topk_psum_tree)
    from repro_torch.dist.pipeline import make_pipelined_fn
    from repro_torch.launch.mesh import make_production_mesh
    _setup()
    mesh = make_mesh((4,), ("data",), device=device)
    dev = mesh.device
    i = _comm.axis_index(mesh, "data")
    g = _t(_cols(inp["g"], i, 4), dev)
    z = torch.zeros_like(g)
    out = {}
    red, err = ef_topk_psum(g, z, mesh, ratio=0.25, axis_name="data")
    out.update(red=_np(red), err=_np(err))
    red2, err2 = ef_topk_psum(z, err, mesh, ratio=0.25, axis_name="data")
    out.update(red2=_np(red2), err2=_np(err2))
    for tag, base, e in (("one", 1.0, z), ("base", 0.25, z),
                         ("hot", 0.25, 4.0 * g)):
        r, ne, ratio = ef_topk_psum_auto(g, e, mesh, base_ratio=base,
                                         axis_name="data")
        out.update({f"auto_{tag}_red": _np(r), f"auto_{tag}_err": _np(ne),
                    f"auto_{tag}_ratio": _np(ratio)})
    out["pmean"] = _np(_comm.pmean(g, mesh, "data"))
    grads = _tree(inp["tree_g"][i], lambda a: _t(a, dev))
    errs = _tree(inp["tree_e"][i], lambda a: _t(a, dev))
    red, err = ef_topk_psum_tree(grads, errs, mesh, ratio=0.1,
                                 axis_name="data")
    out.update({f"tree_red.{k}": _np(v) for k, v in _flat(red).items()})
    out.update({f"tree_err.{k}": _np(v) for k, v in _flat(err).items()})

    # the pipeline: stage i holds ws[i]
    stages = make_mesh((4,), ("stage",), device=device)
    run = make_pipelined_fn(stages, lambda w, x: torch.tanh(x @ w), "stage")
    out["pipeline"] = _np(run(_t(inp["ws"][_comm.axis_index(stages,
                                                             "stage")], dev),
                              _t(inp["xs"], dev)))

    # the mesh builders and the collectives on two axes
    shapes = {}
    for want in ((2, 2), (8, 1), (1, 8), (3, 3)):
        m = make_host_mesh(*want, device=device)
        shapes[want] = (tuple(m.shape.values()), m.coords is not None)
    out["host_shapes"] = shapes
    try:
        make_production_mesh(device=device)
        out["production"] = "built"
    except ValueError as e:
        out["production"] = str(e)
    m = make_host_mesh(2, 2, device=device)
    x = torch.tensor([float(rank + 1)], device=dev)
    out["psum_data"] = _np(_comm.psum(x, m, "data"))
    out["psum_model"] = _np(_comm.psum(x, m, "model"))
    out["pmax_both"] = _np(_comm.pmax(x, m, ("data", "model")))
    out["pmin_both"] = _np(_comm.pmin(x, m, ("data", "model")))
    out["gather_md"] = _np(_comm.all_gather(x, m, ("model", "data")))
    out["index_md"] = _comm.axis_index(m, ("model", "data"))
    out["send_0_to_3"] = _np(_comm.ppermute(x, m, ("data", "model"),
                                            [(0, 3)]))
    return out


# ---------------------------------------------------------------- dp train

def tiny_cfg():
    """The reference's tiny dense config of ``tests/test_dist_train.py``."""
    from repro_torch.configs.base import ModelCfg
    return ModelCfg(name="tiny", family="dense", n_layers=2, d_model=32,
                    n_heads=4, n_kv=2, d_ff=64, vocab=96, dtype="float32")


def case_dp_train(rank, inp, device):
    """``make_dp_train_step`` plain and at ``compress_ratio`` 1.0 from the
    reference's initial params, three steps at 0.05, one rank's step on
    the whole batch, and ``ef_topk_psum_tree`` on the reference's grads
    of this rank's shard.  The plain, 1.0 and one-rank steps also record
    the grads the optimizer got and the grad norm."""
    from repro_torch.dist.compress import ef_topk_psum_tree
    from repro_torch.models import convert
    from repro_torch.train import (adamw_init, init_dp_state, loop,
                                   make_dp_train_step, make_train_step)
    _setup()
    cfg = tiny_cfg()
    mesh = make_mesh((4,), ("data",), device=device)
    dev = mesh.device
    batch = {"tokens": _t(inp["tokens"], dev)}

    def fresh(compress):
        st = init_dp_state(cfg, 0, mesh, compress=compress)
        convert.load_tree(cfg, dict(st["model"].named_parameters()),
                          inp["params"])
        st["opt"] = adamw_init(st["model"].named_parameters())
        return st

    def params(st):
        return _flat(convert.to_reference(cfg, st["model"]))

    out = {}
    update = loop.adamw_update

    def run(tag, step, st):
        """One step, recording the grads ``adamw_update`` got."""
        def capture(params, grads, opt, **kw):
            out[f"{tag}_grads"] = _flat(convert.to_reference(cfg, grads))
            return update(params, grads, opt, **kw)

        loop.adamw_update = capture
        try:
            st, m = step(st, batch)
        finally:
            loop.adamw_update = update
        out.update({f"{tag}_params": params(st),
                    f"{tag}_loss": float(m["loss"]),
                    f"{tag}_gnorm": float(m["grad_norm"])})
        return st

    run("plain", make_dp_train_step(cfg, mesh), fresh(False))
    sc = run("comp", make_dp_train_step(cfg, mesh, compress_ratio=1.0),
             fresh(True))
    out["comp_ef_max"] = max(float(e.abs().max()) for e in sc["ef"].values())
    step = make_dp_train_step(cfg, mesh, compress_ratio=0.05)
    st = fresh(True)
    losses = []
    for _ in range(3):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    out.update(sparse_losses=losses,
               sparse_ef_energy=sum(float(e.abs().sum())
                                    for e in st["ef"].values()),
               sparse_finite=all(bool(torch.isfinite(p).all())
                                 for p in st["model"].parameters()))
    # one replica on the whole batch
    run("one", make_train_step(cfg), fresh(False))
    # the compressed all-reduce on exactly the reference's grads, twice
    # (the second round from the first's residuals)
    g = _tree(inp["grads"][_comm.axis_index(mesh, "data")],
              lambda a: _t(a, dev))
    e = _tree(g, lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                       device=dev))
    for r in (1, 2):
        red, e = ef_topk_psum_tree(g, e, mesh, ratio=0.05, axis_name="data")
        out.update({f"tree{r}_red.{k}": _np(v) for k, v in _flat(red).items()})
        out.update({f"tree{r}_err.{k}": _np(v) for k, v in _flat(e).items()})
    return out


# ---------------------------------------------------------------- EP MoE

def qwen_ep_cfg():
    """qwen3-moe-235b-a22b at smoke size with capacity factor 8, the
    reference's ``test_sharded_moe_matches_auto`` config."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def case_moe_ep(rank, inp, device):
    """The expert-parallel MoE on a (data 2, model 4) mesh of 8 ranks (the
    reference's ``test_sharded_moe_matches_auto``), with every expert held
    and with only this rank's, and on a (data 8, model 1) mesh; then
    granite-moe's ``generate`` on a (2, 2) mesh of the first four ranks
    against one rank's."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import act_specs
    from repro_torch.models import api, moe
    from repro_torch.serve import generate
    _setup()
    mesh = make_mesh((2, 4), ("data", "model"), device=device)
    dev = mesh.device
    cfg = qwen_ep_cfg()
    p = {k: _t(v, dev) for k, v in inp["params"].items()}
    d = _comm.axis_index(mesh, "data")
    x = _t(inp["x"], dev)
    xl = x[2 * d:2 * d + 2]
    out = {}
    with torch.no_grad():
        y, aux = moe.apply_moe(cfg, p, xl, act_specs=act_specs(mesh))
        lo, count = moe.expert_slice(cfg, mesh)
        held = dict(p, **{k: p[k][lo:lo + count].clone()
                          for k in ("gate", "up", "down")})
        y_held, _ = moe.apply_moe(cfg, held, xl, act_specs=act_specs(mesh))
        ids = moe._route(cfg, p["router"], xl.reshape(-1, cfg.d_model))[1]
        y_auto, aux_auto = moe.apply_moe(cfg, p, x)
    out.update(y=_np(y), aux=_np(aux), y_held=_np(y_held), ids=_np(ids),
               y_auto=_np(y_auto), aux_auto=_np(aux_auto), data=d,
               model=_comm.axis_index(mesh, "model"))
    # a model axis of one rank takes the sharded path too, as the
    # reference's does: its psum is the identity, its aux the data mean
    m1 = make_mesh((8, 1), ("data", "model"), device=device)
    i = _comm.axis_index(m1, "data") % x.shape[0]
    with torch.no_grad():
        y1, aux1 = moe.apply_moe(cfg, p, x[i:i + 1], act_specs=act_specs(m1))
        y1_auto, aux1_auto = moe.apply_moe(cfg, p, x[i:i + 1])
    out.update(y_m1=_np(y1), aux_m1=_np(aux1), y_m1_auto=_np(y1_auto),
               aux_m1_auto=_np(aux1_auto))

    gmesh = make_mesh((2, 2), ("data", "model"), device=device)
    if gmesh.coords is None:
        return out
    gcfg = get_config("granite-moe-3b-a800m", smoke=True)
    prompts = _t(inp["prompts"], dev)
    gd = _comm.axis_index(gmesh, "data")
    model = moe.shard_experts(gcfg, api.init(gcfg, seed=0, device=dev),
                              gmesh)
    specs = act_specs(gmesh)
    local = prompts[2 * gd:2 * gd + 2]
    out["greedy"] = _np(generate(gcfg, model, local, max_new_tokens=4,
                                 top_k=1, act_specs=specs))
    gen = torch.Generator(device=dev).manual_seed(100 + gd)
    out["sampled"] = _np(generate(gcfg, model, local, max_new_tokens=4,
                                  top_k=16, top_p=0.9, generator=gen,
                                  act_specs=specs))
    if rank == 0:
        full = api.init(gcfg, seed=0, device=dev)
        out["greedy_one"] = _np(generate(gcfg, full, prompts,
                                         max_new_tokens=4, top_k=1))
    return out


# ---------------------------------------------------------------- EP train

def ep_train_cfg():
    """qwen3-moe-235b-a22b at smoke size with 16 experts (8 on each of two
    model ranks, none of them padding) and capacity factor 8."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=16, capacity_factor=8.0))


def _layer_grads(cfg, p, x, ct, act_specs=None):
    """The MoE layer's output, aux, expert ids and the grads of
    ``sum(out * ct) + aux`` with respect to ``x`` and every leaf of ``p``."""
    from repro_torch.models import moe
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    xg = x.detach().clone().requires_grad_(True)
    y, aux = moe.apply_moe(cfg, leaves, xg, act_specs=act_specs)
    ((y * ct).sum() + aux).backward()
    ids = moe._route(cfg, leaves["router"], x.reshape(-1, cfg.d_model))[1]
    return {"y": _np(y), "aux": float(aux), "ids": _np(ids),
            "g_x": _np(xg.grad),
            **{f"g_{k}": _np(v.grad) for k, v in leaves.items()}}


def case_ep_train(rank, inp, device):
    """The expert-parallel MoE layer under autograd on a (data 2, model 2)
    mesh against the single-rank layer on this rank's data shard, then one
    expert-parallel train step of the whole model (``make_dp_train_step``
    on that mesh, each rank holding only its experts) and the plain data
    parallel step of the same ranks on a (data 2, rep 2) mesh."""
    from repro_torch.dist.sharding import act_specs
    from repro_torch.models import api, convert, moe
    from repro_torch.train import (adamw_init, init_state, loop,
                                   make_dp_train_step)
    _setup()
    cfg = ep_train_cfg()
    mesh = make_mesh((2, 2), ("data", "model"), device=device)
    dev = mesh.device
    d = _comm.axis_index(mesh, "data")
    p = {k: _t(v, dev) for k, v in inp["params"].items()}
    xl = _t(inp["x"], dev)[2 * d:2 * d + 2]
    ctl = _t(inp["ct"], dev)[2 * d:2 * d + 2]
    out = {"data": d, "model": _comm.axis_index(mesh, "model"),
           "slice": moe.expert_slice(cfg, mesh)}
    _comm.reset_collectives()
    out.update({f"ep_{k}": v for k, v in _layer_grads(
        cfg, p, xl, ctl, act_specs(mesh)).items()})
    out["ep_collectives"] = _comm.collectives
    out.update({f"one_{k}": v for k, v in _layer_grads(
        cfg, p, xl, ctl).items()})

    tokens = _t(inp["tokens"], dev)

    def run(tag, step, st):
        """One step, recording the grads ``adamw_update`` got."""
        update = loop.adamw_update

        def capture(params, grads, opt, **kw):
            out[f"{tag}_grads"] = {k: _np(g) for k, g in grads.items()}
            return update(params, grads, opt, **kw)

        loop.adamw_update = capture
        try:
            st, m = step(st, {"tokens": tokens})
        finally:
            loop.adamw_update = update
        out.update({f"{tag}_params": {n: _np(t) for n, t in
                                      st["model"].named_parameters()},
                    f"{tag}_loss": float(m["loss"]),
                    f"{tag}_gnorm": float(m["grad_norm"])})

    def fresh(shard):
        st = init_state(cfg, seed=0, device=dev)
        convert.load_tree(cfg, dict(st["model"].named_parameters()),
                          inp["model"])
        if shard:
            moe.shard_experts(cfg, st["model"], mesh)
        st["opt"] = adamw_init(st["model"].named_parameters())
        return st

    run("step", make_dp_train_step(cfg, mesh), fresh(True))
    # the same ranks as data parallelism alone: every rank all experts
    rep = make_mesh((2, 2), ("data", "rep"), device=device)
    run("dp", make_dp_train_step(cfg, rep), fresh(False))
    return out


# ---------------------------------------------------------------- bank mesh

def case_bankmesh(rank, inp, device):
    """The §IV bank mesh over ranks (``dist/bankmesh.py:sharded_tile_fn``):
    each of ``inp["tiles"]`` on 4 banks, one a rank, over the one-axis
    ``banks`` mesh or the (hosts 2, banks 2) tuple; the outputs and the
    collectives each tile made."""
    from repro_torch.dist.bankmesh import sharded_tile_fn
    _setup()
    meshes = {"banks": make_mesh((4,), ("banks",), device=device),
              "hosts": make_mesh((2, 2), ("hosts", "banks"), device=device)}
    out = []
    for t in inp["tiles"]:
        mesh = meshes[t["axes"]]
        axes = "banks" if t["axes"] == "banks" else ("hosts", "banks")
        x = t["x"]
        fn = sharded_tile_fn(mesh, axes, t["w"], t["k"],
                             t["stop"] or x.shape[1], t["packed"], t["fuse"])
        _comm.reset_collectives()
        got = fn(_t(x.view(np.int32), mesh.device))
        out.append({"outs": [_np(g.view(torch.int32) if g.dtype ==
                                 torch.uint32 else g) for g in got],
                    "collectives": _comm.collectives,
                    "collective_s": _comm.collective_s})
    return out


# ---------------------------------------------------------------- inputs

def distsort_inputs():
    """The reference's ``tests/test_distsort.py`` inputs: two (B, N) float
    rows (distinct, heavy ties) and 12 trials of uniform, heavy-duplicate
    and all-equal uint32 rows with their k values."""
    rng = np.random.default_rng(1)
    inp = {"x": rng.normal(size=(4, 512)).astype(np.float32),
           "ties": np.repeat(rng.normal(size=(2, 64)).astype(np.float32), 8,
                             -1)}
    rng = np.random.default_rng(7)
    trials, ks = [], []
    for trial in range(12):
        b = int(rng.integers(1, 5))
        n = int(rng.choice([8, 32, 128, 512]))
        kind = trial % 3
        if kind == 0:          # full-range uniform
            u = rng.integers(0, 1 << 32, (b, n), dtype=np.uint64)
        elif kind == 1:        # heavy duplicates (ties at the threshold)
            u = rng.integers(0, 7, (b, n), dtype=np.uint64)
        else:                  # adversarial: every element equal
            u = np.full((b, n), int(rng.integers(0, 1 << 32)), np.uint64)
        trials.append(u.astype(np.uint32))
        ks.append(sorted({1, 2, n // 2, n - 1, n} - {0}))
    inp.update(trials=trials, trial_ks=ks)
    return inp


def compress_inputs():
    """The reference's gradient of ``test_dist_features.py`` (64,), a tree
    of grads and residuals a rank, and the pipeline's stages and
    microbatches."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(64,)).astype(np.float32)
    trng = np.random.default_rng(5)

    def tree(scale):
        return {"a": (trng.normal(size=(4, 8, 16)) * scale).astype(np.float32),
                "b": {"c": (trng.normal(size=(32,)) * scale).astype(
                    np.float32)}}

    return {"g": g, "tree_g": [tree(1.0) for _ in range(4)],
            "tree_e": [tree(0.3) for _ in range(4)],
            "ws": (rng.normal(size=(4, 8, 8)) * 0.5).astype(np.float32),
            "xs": rng.normal(size=(6, 3, 8)).astype(np.float32)}


def dp_tokens():
    """The dp_train case's token batch: (8, 16) ids of the tiny config's 96."""
    return np.random.default_rng(0).integers(0, 96, size=(8, 16)).astype(
        np.int32)


def dp_train_inputs_from_port():
    """The dp_train case's inputs drawn by the port itself (no jax): the
    tiny config's params (seed 0) and each of 4 shards' grads, as the
    reference's trees of numpy arrays (layers stacked)."""
    from repro_torch.models import api, convert
    cfg = tiny_cfg()
    tokens = dp_tokens()
    model = api.init(cfg, seed=0, device="cpu").trainable(True)
    grads = []
    for i in range(4):
        model.zero_grad(set_to_none=True)
        api.loss(cfg, model, {"tokens": torch.as_tensor(
            tokens[2 * i:2 * i + 2])})[0].backward()
        grads.append(convert.to_reference(cfg, {
            n: p.grad for n, p in model.named_parameters()}))
    return {"tokens": tokens, "params": convert.to_reference(cfg, model),
            "grads": grads}


def moe_ep_inputs(params):
    """The EP case's inputs around ``params`` (the MoE layer's, numpy)."""
    d = params["router"].shape[0]
    return {"params": params,
            "x": np.random.default_rng(0).normal(size=(4, 32, d)).astype(
                np.float32),
            "prompts": np.random.default_rng(2).integers(0, 256, (4, 8))
            .astype(np.int32)}


def topk_oracle(cs, k):
    """What ``ef_topk_psum`` must give on ranks holding ``cs`` (each rank's
    compensated gradient, flattened): the top-k of |c| over the ranks'
    concatenation, the lowest index first among ties (bank-major, then
    index-major), as one process computes it -> (the reduced sum, each
    rank's residual)."""
    from repro_torch.core.topk import topk_mask
    c = torch.as_tensor(np.concatenate(cs))
    mask = topk_mask(c.abs()[None], k)[0]
    sel = torch.where(mask, c, torch.zeros_like(c)).numpy()
    n = cs[0].size
    parts = [sel[r * n:(r + 1) * n] for r in range(len(cs))]
    return (np.sum(parts, axis=0, dtype=np.float32),
            [c_r - p for c_r, p in zip(cs, parts)])


def run_case(case, inp, *, device="cpu"):
    """Start the case's ranks on ``gloo``; their results in rank order."""
    return spawn(globals()[f"case_{case}"], WORLD[case], backend="gloo",
                 device=device, args=(inp, device))


def run_pair(case, inp, tmp, *, ndev, timeout=600):
    """The case in two processes at once: the port's ranks on the CPU
    (this file as a script) and the JAX package's side
    (``_jax_dist_ref.py``, ``ndev`` forced host devices).  Returns
    ``(the port ranks' results, the reference's results)``."""
    import subprocess
    tmp = str(tmp)
    with open(os.path.join(tmp, "in.pkl"), "wb") as f:
        pickle.dump(inp, f)
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(HERE),
                                                    "src")}
    cmds = [[sys.executable, os.path.join(HERE, "_torch_dist_ranks.py"),
             case, tmp],
            [sys.executable, os.path.join(HERE, "_jax_dist_ref.py"), case,
             tmp, str(ndev)]]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for c in cmds]
    for c, p in zip(cmds, procs):
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"{os.path.basename(c[1])}: {err[-4000:]}"
    loaded = []
    for name in ("port.pkl", "ref.pkl"):
        with open(os.path.join(tmp, name), "rb") as f:
            loaded.append(pickle.load(f))
    return tuple(loaded)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("case", choices=sorted(WORLD))
    ap.add_argument("dir")
    args = ap.parse_args(argv)
    with open(os.path.join(args.dir, "in.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = run_case(args.case, inp)
    with open(os.path.join(args.dir, "port.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
