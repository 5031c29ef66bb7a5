"""The expert-parallel MoE path (``models/moe.py:_apply_moe_sharded``)
against the JAX package's ``shard_map`` path.

qwen3-moe-235b-a22b at smoke size with ``capacity_factor=8`` on a (data 2,
model 4) mesh (the reference's ``test_sharded_moe_matches_auto``,
``tests/test_dist_features.py:138-157``): 8 ``gloo`` ranks on the CPU
against 8 forced host devices, from the reference's ``moe_params``.  The
port's sharded output equals the reference's sharded output and the
port's own auto path within 2e-5, whether a rank holds every expert or
only its own; expert ids are exact.  On a (data 8, model 1) mesh the
sharded path runs too, as the reference's does, and its aux is the mean
over the data ranks.  Then granite-moe-3b-a800m at smoke
size: ``generate`` with ``act_specs`` on a (2, 2) mesh gives the greedy
tokens of one rank, and the model ranks of a data row sample the same
tokens from generators seeded alike.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_dist_ranks import run_pair
from repro.configs import get_config as ref_config
from repro.models.moe import moe_params as ref_moe_params
from repro_torch.configs import get_config
from repro_torch.dist import _comm
from repro_torch.models import moe

TOL = 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg0 = ref_config("qwen3-moe-235b-a22b", smoke=True)
    cfg = dataclasses.replace(
        cfg0, moe=dataclasses.replace(cfg0.moe, capacity_factor=8.0))
    params = jax.tree.map(np.asarray, ref_moe_params(cfg, jax.random.key(0)))
    x = np.random.default_rng(0).normal(size=(4, 32, cfg.d_model)).astype(
        np.float32)
    prompts = np.random.default_rng(2).integers(0, 256, (4, 8)).astype(
        np.int32)
    inp = {"params": params, "x": x, "prompts": prompts}
    port, ref = run_pair("moe_ep", inp, tmp_path_factory.mktemp("ep"),
                         ndev=8)
    return inp, port, ref


def _by_data(port, key, model=0):
    """The data rows' outputs, from the ranks at ``model``."""
    rows = sorted((p["data"], p[key]) for p in port if p["model"] == model)
    return np.concatenate([r for _, r in rows])


def test_sharded_output_matches_reference_and_auto(runs):
    _, port, ref = runs
    assert float(np.abs(ref["y_sh"] - ref["y_auto"]).max()) < 1e-4
    for m in range(4):
        y = _by_data(port, "y", m)
        np.testing.assert_allclose(y, ref["y_sh"], rtol=0, atol=TOL)
        np.testing.assert_allclose(y, port[0]["y_auto"], rtol=0, atol=TOL)
        assert np.array_equal(y, _by_data(port, "y_held", m))
    np.testing.assert_allclose(port[0]["y_auto"], ref["y_auto"], rtol=0,
                               atol=TOL)


def test_expert_ids_exact(runs):
    _, port, ref = runs
    for m in range(4):
        assert np.array_equal(_by_data(port, "ids", m), ref["ids"])


def test_aux_is_the_mean_over_every_rank(runs):
    _, port, ref = runs
    # each data shard's aux, averaged over the mesh: the same on every rank
    auxes = {float(p["aux"]) for p in port}
    assert len(auxes) == 1
    np.testing.assert_allclose(auxes.pop(), ref["aux_sh"], rtol=1e-5)


def test_one_model_rank_takes_the_sharded_path(runs):
    _, port, _ = runs
    # on (data 8, model 1) each rank's output is its auto path's, and its
    # aux is the mean of the 8 ranks' own, the same on every rank
    mean = np.mean([p["aux_m1_auto"] for p in port], dtype=np.float64)
    for p in port:
        assert np.array_equal(p["y_m1"], p["y_m1_auto"])
        assert p["aux_m1"] == port[0]["aux_m1"]
        np.testing.assert_allclose(p["aux_m1"], mean, rtol=1e-6)
    assert len({float(p["aux_m1_auto"]) for p in port}) > 1


def test_generate_on_a_mesh_equals_one_rank(runs):
    _, port, _ = runs
    in_mesh = [p for p in port if "greedy" in p]
    assert len(in_mesh) == 4
    one = port[0]["greedy_one"]
    for r, p in enumerate(in_mesh):
        d = r // 2
        assert np.array_equal(p["greedy"], one[2 * d:2 * d + 2]), r
    # the two model ranks of each data row sample the same tokens
    for d in range(2):
        assert np.array_equal(in_mesh[2 * d]["sampled"],
                              in_mesh[2 * d + 1]["sampled"])


def test_expert_slices_and_refusals():
    cfg = get_config("granite-moe-3b-a800m")
    mesh = _comm.AbstractMesh({"data": 2, "model": 2})
    mesh.coords = {"data": 1, "model": 1}
    assert moe.expert_slice(cfg, mesh) == (24, 24)
    bad = _comm.AbstractMesh({"model": 5})
    bad.coords = {"model": 0}
    with pytest.raises(ValueError, match="does not divide"):
        moe.expert_slice(cfg, bad)
    small = get_config("granite-moe-3b-a800m", smoke=True)
    p = {k: torch.zeros(3, 1, 1) for k in ("gate", "up", "down")}
    with pytest.raises(ValueError, match="experts held"):
        moe._local_experts(small, p, mesh)
