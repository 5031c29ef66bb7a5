"""The JAX package's side of the port's distribution tests.

    python tests/_jax_dist_ref.py CASE DIR NDEV

forces ``NDEV`` host devices (as the reference's own multi-device tests
do), runs the case's functions of ``repro`` under ``shard_map`` on the
inputs of ``DIR/in.pkl`` and writes ``DIR/ref.pkl`` (numpy arrays).
"""

import os
import pickle
import sys

CASE, DIR, NDEV = sys.argv[1], sys.argv[2], int(sys.argv[3])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={NDEV}"
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from repro.dist._jaxcompat import shard_map  # noqa: E402


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def mesh_of(n, names):
    return Mesh(np.array(jax.devices()[:int(np.prod(n))]).reshape(n), names)


def distsort(inp):
    from repro.core.distsort import (global_min_sharded, kth_largest_sharded,
                                     topk_mask_sharded)
    from repro.core.topk import to_sortable_uint
    out = {}
    m8 = mesh_of((8,), ("banks",))
    f = smap(lambda xl: topk_mask_sharded(xl, 13, "banks"), m8,
             P(None, "banks"), P(None, "banks"))
    for name in ("x", "ties"):
        out[f"{name}_mask8"] = np.asarray(f(jnp.asarray(inp[name])))
    g = smap(lambda ul: global_min_sharded(ul, "banks"), m8,
             P(None, "banks"), P(None))
    out["ties_min8"] = np.asarray(g(to_sortable_uint(jnp.asarray(
        inp["ties"]))))
    m4 = mesh_of((4,), ("banks",))
    for j, (u, ks) in enumerate(zip(inp["trials"], inp["trial_ks"])):
        uj = jnp.asarray(u)
        for k in ks:
            out[f"t{j}_kth{k}"] = np.asarray(smap(
                lambda ul, k=int(k): kth_largest_sharded(ul, k, "banks"), m4,
                P(None, "banks"), P(None))(uj))
        out[f"t{j}_min"] = np.asarray(smap(
            lambda ul: global_min_sharded(ul, "banks"), m4, P(None, "banks"),
            P(None))(uj))
        out[f"t{j}_mask5"] = np.asarray(smap(
            lambda ul, k=min(5, u.shape[-1]): topk_mask_sharded(ul, k,
                                                                "banks"),
            m4, P(None, "banks"), P(None, "banks"))(uj))
    return out


def compress(inp):
    from repro.dist.compress import (ef_topk_psum, ef_topk_psum_auto,
                                     ef_topk_psum_tree)
    mesh = mesh_of((4,), ("data",))
    out = {}
    f = smap(lambda g, e: ef_topk_psum(g, e, ratio=0.25, axis_name="data"),
             mesh, (P("data"), P("data")), (P("data"), P("data")))
    g = jnp.asarray(inp["g"])
    z = jnp.zeros_like(g)
    red, err = f(g, z)
    red2, err2 = f(z, err)
    out.update(red=np.asarray(red), err=np.asarray(err), red2=np.asarray(red2),
               err2=np.asarray(err2))
    for tag, base, e in (("one", 1.0, z), ("base", 0.25, z),
                         ("hot", 0.25, 4.0 * g)):
        fa = smap(lambda g, e, b=base: ef_topk_psum_auto(
            g, e, base_ratio=b, axis_name="data"), mesh,
            (P("data"), P("data")), (P("data"), P("data"), P()))
        r, ne, ratio = fa(g, e)
        out.update({f"auto_{tag}_red": np.asarray(r),
                    f"auto_{tag}_err": np.asarray(ne),
                    f"auto_{tag}_ratio": np.asarray(ratio)})
    out["pmean"] = np.asarray(smap(lambda x: jax.lax.pmean(x, "data"), mesh,
                                   P("data"), P("data"))(g))
    stack = lambda trees: jax.tree.map(  # noqa: E731
        lambda *a: jnp.stack([jnp.asarray(x) for x in a]), *trees)

    def tree_fn(gs, es):
        gs = jax.tree.map(lambda a: a[0], gs)
        es = jax.tree.map(lambda a: a[0], es)
        red, err = ef_topk_psum_tree(gs, es, ratio=0.1, axis_name="data")
        return (jax.tree.map(lambda a: a[None], red),
                jax.tree.map(lambda a: a[None], err))

    red, err = smap(tree_fn, mesh, (P("data"), P("data")),
                    (P("data"), P("data")))(stack(inp["tree_g"]),
                                            stack(inp["tree_e"]))
    out.update({f"tree_red.{k}": v for k, v in flat(red).items()})
    out.update({f"tree_err.{k}": v for k, v in flat(err).items()})
    return out


def dp_train(inp):
    from repro.configs.base import ModelCfg
    from repro.dist.compress import ef_topk_psum_tree
    from repro.train.loop import init_dp_state, make_dp_train_step
    cfg = ModelCfg(name="tiny", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv=2, d_ff=64, vocab=96, dtype="float32")
    mesh = mesh_of((4,), ("data",))
    batch = {"tokens": jnp.asarray(inp["tokens"], jnp.int32)}
    out = {}
    sd, md = jax.jit(make_dp_train_step(cfg, mesh))(
        init_dp_state(cfg, jax.random.key(0), mesh), batch)
    sc, mc = jax.jit(make_dp_train_step(cfg, mesh, compress_ratio=1.0))(
        init_dp_state(cfg, jax.random.key(0), mesh, compress=True), batch)
    out.update(plain_params=flat(sd["params"]), plain_loss=float(md["loss"]),
               plain_gnorm=float(md["grad_norm"]),
               comp_params=flat(sc["params"]), comp_loss=float(mc["loss"]),
               comp_gnorm=float(mc["grad_norm"]),
               comp_ef_max=max(float(jnp.abs(e).max())
                               for e in jax.tree.leaves(sc["ef"])))
    stack = lambda trees: jax.tree.map(  # noqa: E731
        lambda *a: jnp.stack([jnp.asarray(x) for x in a]), *trees)

    def tree_fn(gs, es):
        gs = jax.tree.map(lambda a: a[0], gs)
        es = jax.tree.map(lambda a: a[0], es)
        red, err = ef_topk_psum_tree(gs, es, ratio=0.05, axis_name="data")
        return (jax.tree.map(lambda a: a[None], red),
                jax.tree.map(lambda a: a[None], err))

    fn = smap(tree_fn, mesh, (P("data"), P("data")), (P("data"), P("data")))
    gs = stack(inp["grads"])
    es = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), gs)
    for r in (1, 2):
        red, es = fn(gs, es)
        out.update({f"tree{r}_red.{k}": v for k, v in flat(red).items()})
        out.update({f"tree{r}_err.{k}": v for k, v in flat(es).items()})
    return out


def moe_ep(inp):
    import dataclasses
    from repro.configs import get_config
    from repro.dist import sharding as shd
    from repro.models.moe import _route, apply_moe
    cfg0 = get_config("qwen3-moe-235b-a22b", smoke=True)
    cfg = dataclasses.replace(
        cfg0, moe=dataclasses.replace(cfg0.moe, capacity_factor=8.0))
    params = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    x = jnp.asarray(inp["x"])
    y_auto, aux_auto = jax.jit(lambda p, x: apply_moe(cfg, p, x))(params, x)
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    aspecs = shd.act_specs(mesh)
    with mesh:
        y_sh, aux_sh = jax.jit(
            lambda p, x: apply_moe(cfg, p, x, act_specs=aspecs))(params, x)
    ids = _route(cfg, params["router"], x.reshape(-1, cfg.d_model))[1]
    return {"y_auto": np.asarray(y_auto), "aux_auto": np.asarray(aux_auto),
            "y_sh": np.asarray(y_sh), "aux_sh": np.asarray(aux_sh),
            "ids": np.asarray(ids)}


def ep_train(inp):
    """The reference's expert-parallel layer and train step on a (data 2,
    model 2) mesh: ``jax.grad`` of ``sum(out * ct) / 2 + aux`` (the mean
    over the two data shards of each shard's ``sum(out * ct)``) through
    the ``shard_map`` layer and through the auto layer, and one
    ``make_train_step(cfg, act_specs=...)`` step under the mesh."""
    import dataclasses
    from repro.configs import get_config
    from repro.dist import sharding as shd
    from repro.models.moe import _route, apply_moe
    from repro.train.loop import make_train_step
    from repro.train.optimizer import adamw_init
    cfg0 = get_config("qwen3-moe-235b-a22b", smoke=True)
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, n_experts=16, capacity_factor=8.0))
    p = {k: jnp.asarray(v) for k, v in inp["params"].items()}
    x, ct = jnp.asarray(inp["x"]), jnp.asarray(inp["ct"])
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    aspecs = shd.act_specs(mesh)

    def objective(specs):
        def f(x, p):
            y, aux = apply_moe(cfg, p, x, act_specs=specs)
            return jnp.sum(y * ct) / 2 + aux
        return jax.jit(jax.grad(f, argnums=(0, 1)))

    out = {"ids": np.asarray(_route(cfg, p["router"],
                                    x.reshape(-1, cfg.d_model))[1])}
    with mesh:
        gx, gp = objective(aspecs)(x, p)
    out.update(ep_g_x=np.asarray(gx),
               **{f"ep_g_{k}": np.asarray(v) for k, v in gp.items()})
    gx, gp = objective(None)(x, p)
    out.update(auto_g_x=np.asarray(gx),
               **{f"auto_g_{k}": np.asarray(v) for k, v in gp.items()})

    params = jax.tree.map(jnp.asarray, inp["model"])
    state = {"params": params, "opt": adamw_init(params)}
    batch = {"tokens": jnp.asarray(inp["tokens"], jnp.int32)}
    with mesh:
        st, m = jax.jit(make_train_step(cfg, act_specs=aspecs))(state, batch)
    out.update(step_params=flat(st["params"]), step_loss=float(m["loss"]),
               step_gnorm=float(m["grad_norm"]))
    return out


if __name__ == "__main__":
    with open(os.path.join(DIR, "in.pkl"), "rb") as f:
        inputs = pickle.load(f)
    result = globals()[CASE](inputs)
    with open(os.path.join(DIR, "ref.pkl"), "wb") as f:
        pickle.dump(result, f)
    print("OK")
