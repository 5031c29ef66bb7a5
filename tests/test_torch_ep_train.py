"""Expert-parallel training (``models/moe.py:_apply_moe_sharded`` under
autograd, ``train.make_dp_train_step`` on a mesh with a ``model`` axis)
against the JAX package's ``shard_map`` layer and its train step.

qwen3-moe-235b-a22b at smoke size with 16 experts (8 live ones on each of
two model ranks) and capacity factor 8, on a (data 2, model 2) mesh: 4
``gloo`` ranks on the CPU against 4 forced host devices, from the
reference's ``moe_params`` and ``api.init``.

  * The layer: each rank's grads of ``sum(out * ct) + aux`` on its data
    shard (``x``, the router, every expert leaf) equal the single-rank
    layer's on that shard, its own experts' slices in full and the rest
    zero, within ``TOL`` of each leaf's largest value; expert ids exact.
  * Against ``jax.grad`` of ``sum(out * ct) / 2 + aux`` (the mean over
    the data shards) of the reference's ``shard_map`` layer: its ``x``
    grad is each rank's halved, and its router and expert grads the mean
    over the data ranks of theirs, which is what a data-parallel step
    feeds its optimizer.  The reference's auto layer gives the same
    expert grads (its aux is the whole batch's, a different function).
  * One train step: the loss, the grad norm and every updated leaf (a
    rank's experts against their slice) within ``STEP_REL`` of the
    reference's ``make_train_step(cfg, act_specs=act_specs(mesh))``, and
    of the plain data-parallel step of the same four ranks, every rank
    holding every expert (a (data 2, rep 2) mesh); the grads the
    optimizer got within ``TOL`` of that step's.
"""

import dataclasses

import jax
import numpy as np
import pytest

from _torch_dist_ranks import _flat, run_pair
from repro.configs import get_config as ref_config
from repro.models import api as ref_api
from repro.models.moe import moe_params as ref_moe_params

TOL = 2e-5          # a grad leaf, of its largest value (float32)
STEP_REL = 2e-5     # a train step's loss, norm and params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg0 = ref_config("qwen3-moe-235b-a22b", smoke=True)
    cfg = dataclasses.replace(cfg0, moe=dataclasses.replace(
        cfg0.moe, n_experts=16, capacity_factor=8.0))
    rng = np.random.default_rng(0)
    inp = {"params": jax.tree.map(np.asarray,
                                  ref_moe_params(cfg, jax.random.key(0))),
           "x": rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32),
           "ct": rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32),
           "model": jax.tree.map(np.asarray,
                                 ref_api.init(cfg, jax.random.key(1))),
           "tokens": rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)}
    port, ref = run_pair("ep_train", inp, tmp_path_factory.mktemp("ept"),
                         ndev=4)
    return inp, port, ref


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _expert_slice(a, p):
    lo, count = p["slice"]
    return a[lo:lo + count]


def test_ep_layer_grads_equal_single_rank_on_the_shard(runs):
    _, port, _ = runs
    for p in port:
        assert np.array_equal(p["ep_ids"], p["one_ids"])
        _close(p["ep_y"], p["one_y"], TOL, "y")
        for k in ("g_x", "g_router"):
            _close(p[f"ep_{k}"], p[f"one_{k}"], TOL, k)
        lo, count = p["slice"]
        for k in ("gate", "up", "down"):
            g = p[f"ep_g_{k}"]
            _close(g[lo:lo + count], _expert_slice(p[f"one_g_{k}"], p),
                   TOL, k)
            assert not np.delete(g, np.s_[lo:lo + count], 0).any(), k
        assert p["ep_collectives"] > 0
    # the model ranks of a data row hold the same x and router grads
    for d in range(2):
        row = [p for p in port if p["data"] == d]
        for k in ("ep_g_x", "ep_g_router"):
            assert np.array_equal(row[0][k], row[1][k]), k


def test_ep_layer_grads_match_the_reference(runs):
    _, port, ref = runs
    ids = np.concatenate([p["ep_ids"] for p in sorted(
        port, key=lambda p: p["data"]) if p["model"] == 0])
    assert np.array_equal(ids, ref["ids"])
    by_data = sorted((p for p in port if p["model"] == 0),
                     key=lambda p: p["data"])
    gx = np.concatenate([p["ep_g_x"] for p in by_data]) / 2
    _close(gx, ref["ep_g_x"], TOL, "x")
    _close(np.mean([p["ep_g_router"] for p in by_data], 0),
           ref["ep_g_router"], TOL, "router")
    # the auto layer's aux is the whole batch's, not the mean of the
    # shards', so only its expert grads (which the aux does not reach)
    # are the same function's
    assert np.abs(ref["auto_g_x"] - ref["ep_g_x"]).max() > TOL
    for kind in ("ep", "auto"):
        for k in ("gate", "up", "down"):
            for m in range(2):
                mine = [p for p in port if p["model"] == m]
                want = _expert_slice(ref[f"{kind}_g_{k}"], mine[0])
                got = np.mean([_expert_slice(p[f"ep_g_{k}"], p)
                               for p in mine], 0)
                _close(got, want, TOL, f"{kind} {k} model {m}")


def test_ep_train_step_matches_the_reference(runs):
    _, port, ref = runs
    want = ref["step_params"]
    for p in port:
        assert abs(p["step_loss"] - ref["step_loss"]) <= \
            STEP_REL * abs(ref["step_loss"])
        assert abs(p["step_gnorm"] - ref["step_gnorm"]) <= \
            STEP_REL * ref["step_gnorm"]
        got = _flat(_to_reference(p["step_params"]))
        assert sorted(got) == sorted(want)
        for k, v in got.items():
            w = want[k]
            if k.split(".")[-1] in ("gate", "up", "down"):
                w = w[:, slice(*_range(p))]
            _close(v, w, STEP_REL, k)


def test_ep_train_step_equals_the_data_parallel_step(runs):
    _, port, _ = runs
    for p in port:
        assert abs(p["step_loss"] - p["dp_loss"]) <= \
            STEP_REL * abs(p["dp_loss"])
        assert abs(p["step_gnorm"] - p["dp_gnorm"]) <= \
            STEP_REL * p["dp_gnorm"]
        for k, v in p["step_grads"].items():
            w = p["dp_grads"][k]
            if v.shape != w.shape:                # this rank's experts
                w = _expert_slice(w, p)
            _close(v, w, TOL, k)
        for k, v in p["step_params"].items():
            w = p["dp_params"][k]
            if v.shape != w.shape:
                w = _expert_slice(w, p)
            _close(v, w, STEP_REL, k)


def _range(p):
    lo, count = p["slice"]
    return lo, lo + count


def _to_reference(named):
    """The port's parameter names -> the reference's tree, the blocks
    stacked on a leading axis (any expert count)."""
    import torch
    from repro_torch.models import convert
    cfg = get_ep_cfg()
    return convert.to_reference(cfg, {k: torch.as_tensor(v)
                                      for k, v in named.items()})


def get_ep_cfg():
    from _torch_dist_ranks import ep_train_cfg
    return ep_train_cfg()
