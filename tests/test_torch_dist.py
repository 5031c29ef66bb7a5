"""``repro_torch.dist``: compression, sharding rules, the pipeline, meshes.

  * compression: ``ef_topk_psum``, ``_auto`` and ``_tree`` on 4 ``gloo``
    ranks on the CPU against the JAX package's on 4 forced host devices
    (``tests/_torch_dist_ranks.py``, ``tests/_jax_dist_ref.py``): masks
    and residuals equal, ``reduced`` within 1e-6 (4 float32 values summed
    in another order), ``ratio_used`` equal at base 1.0; then the
    reference's own assertions (``tests/test_dist_features.py:30-117``) on
    the port;
  * sharding: for all ten archs at full size, built on ``meta``,
    ``param_specs`` equal to the reference's on ``jax.eval_shape`` leaf for
    leaf, at 16 x 16 and 2 x 2; ``act_specs``, ``cache_spec`` and the
    reference's two invariants (``test_dist_features.py:160-195``);
  * the pipeline against its stages applied one after another (1e-5; the
    reference's own pipeline test fails under jax 0.9.0);
  * the mesh builders and the collectives over tuples of axes.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_dist_ranks import compress_inputs, run_pair, topk_oracle
from repro.configs import ARCHS, get_config as ref_config
from repro.dist import sharding as ref_shd
from repro.models import api as ref_api
from repro_torch.configs import get_config
from repro_torch.dist import _comm, sharding
from repro_torch.models import api

REDUCE_TOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = compress_inputs()
    port, ref = run_pair("compress", inp, tmp_path_factory.mktemp("comp"),
                         ndev=4)
    return inp, port, ref


def _cat(port, key):
    return np.concatenate([p[key] for p in port], 0)


# ------------------------------------------------------------- compression

@pytest.mark.parametrize("tag", ["", "2", "_auto_one", "_auto_base",
                                 "_auto_hot"])
def test_ef_topk_psum_matches_reference(runs, tag):
    _, port, ref = runs
    red, err = (("red" + tag, "err" + tag) if not tag.startswith("_")
                else (tag[1:] + "_red", tag[1:] + "_err"))
    assert np.array_equal(_cat(port, err), ref[err])
    np.testing.assert_allclose(_cat(port, red), ref[red], rtol=0,
                               atol=REDUCE_TOL)
    # the selected set: every coordinate with no residual left
    assert np.array_equal(_cat(port, err) == 0, ref[err] == 0)


def test_ratio_used_matches_reference(runs):
    _, port, ref = runs
    for p in port:
        assert float(p["auto_one_ratio"]) == float(ref["auto_one_ratio"]) \
            == 1.0
        for tag in ("base", "hot"):
            np.testing.assert_allclose(p[f"auto_{tag}_ratio"],
                                       ref[f"auto_{tag}_ratio"], rtol=1e-6)


def test_ef_topk_psum_tree_matches_reference(runs):
    _, port, ref = runs
    keys = [k for k in ref if k.startswith("tree_")]
    assert sorted(keys) == sorted(k for k in port[0] if k.startswith("tree_"))
    for k in keys:
        got = np.stack([p[k] for p in port])
        if k.startswith("tree_err"):
            assert np.array_equal(got, ref[k]), k
        else:
            np.testing.assert_allclose(got, ref[k], rtol=0, atol=REDUCE_TOL)


def test_compressed_reduce_equals_one_process_oracle(runs):
    # the global top-k of |g + e| over the 4 ranks' concatenation, the
    # lowest index first among ties, computed in one process
    inp, port, _ = runs
    red, errs = topk_oracle(np.split(inp["g"], 4), 16)
    assert np.array_equal(_cat(port, "err"), np.concatenate(errs))
    np.testing.assert_allclose(port[0]["red"], red, rtol=0, atol=REDUCE_TOL)
    for path, get in (("a", lambda t: t["a"]), ("b.c", lambda t: t["b"]["c"])):
        cs = [(get(inp["tree_g"][r]) + get(inp["tree_e"][r])).ravel()
              for r in range(4)]
        red, errs = topk_oracle(cs, round(0.1 * 4 * cs[0].size))
        for r, p in enumerate(port):
            assert np.array_equal(p[f"tree_err.{path}"].ravel(), errs[r])
            np.testing.assert_allclose(p[f"tree_red.{path}"].ravel(), red,
                                       rtol=0, atol=REDUCE_TOL)


def test_reference_assertions_hold_on_the_port(runs):
    """``test_ef_topk_gradient_compression`` and
    ``test_ef_topk_energy_schedule`` on the port's outputs."""
    inp, port, _ = runs
    g = inp["g"]
    err, err2 = _cat(port, "err"), _cat(port, "err2")
    thresh = np.sort(np.abs(g))[-16]
    mask = np.abs(g) >= thresh
    assert (np.abs(err[mask]) < 1e-6).all()
    assert np.allclose(err[~mask], g[~mask], atol=1e-6)
    assert (np.abs(err2) <= np.abs(err) + 1e-6).all()
    # base 1.0: reduced / n is the pmean exactly, no residual, ratio 1.0
    assert np.array_equal(_cat(port, "auto_one_red") / 4.0,
                          _cat(port, "pmean"))
    assert np.array_equal(_cat(port, "auto_one_err"), np.zeros(64))
    # zero residual: the ratio sits at base, 16 coordinates selected
    assert abs(float(port[0]["auto_base_ratio"]) - 0.25) < 1e-6
    assert int((np.abs(_cat(port, "auto_base_err")) < 1e-9).sum()) == 16
    # an energetic residual opens the ratio past base
    assert float(port[0]["auto_hot_ratio"]) > 0.25


# ------------------------------------------------------------- pipeline

def test_pipeline_matches_sequential(runs):
    inp, port, _ = runs
    want = inp["xs"]
    for i in range(4):
        want = np.tanh(want @ inp["ws"][i])
    for p in port:        # broadcast from the last stage to every rank
        np.testing.assert_allclose(p["pipeline"], want, rtol=0, atol=1e-5)


# ------------------------------------------------------------- meshes

def test_mesh_builders_and_collectives(runs):
    _, port, _ = runs
    for r, p in enumerate(port):
        assert p["host_shapes"] == {(2, 2): ((2, 2), True),
                                    (8, 1): ((4, 1), True),
                                    (1, 8): ((1, 4), True),
                                    (3, 3): ((3, 1), r < 3)}
        assert "needs a group of 256 ranks, not 4" in p["production"]
        d, m = divmod(r, 2)
        assert p["psum_data"].tolist() == [[4.0, 6.0][m]]
        assert p["psum_model"].tolist() == [[3.0, 7.0][d]]
        assert p["pmax_both"].tolist() == [4.0]
        assert p["pmin_both"].tolist() == [1.0]
        # ("model", "data") linearises model-major
        assert p["gather_md"].ravel().tolist() == [1.0, 3.0, 2.0, 4.0]
        assert p["index_md"] == m * 2 + d
        assert p["send_0_to_3"].tolist() == [1.0 if r == 3 else 0.0]


def test_one_rank_axes_are_identities():
    mesh = _comm.AbstractMesh({"data": 1, "model": 1})
    mesh.coords = {"data": 0, "model": 0}
    x = torch.arange(3.0)
    before = _comm.collectives
    assert _comm.psum(x, mesh, "data") is x
    assert _comm.pmean(x, mesh, ("data", "model")) is x
    assert torch.equal(_comm.all_gather(x, mesh, "model"), x[None])
    assert torch.equal(_comm.ppermute(x, mesh, "data", [(0, 0)]), x)
    assert torch.equal(_comm.ppermute(x, mesh, "data", []), torch.zeros(3))
    assert _comm.axis_index(mesh, ("data", "model")) == 0
    assert _comm.collectives == before


# ------------------------------------------------------------- sharding

def _ref_specs(arch, sizes):
    cfg = ref_config(arch)
    shapes = jax.eval_shape(lambda c=cfg: ref_api.init(c, jax.random.key(0)))
    specs = ref_shd.param_specs(shapes, axis_sizes=sizes)
    out = {}
    for (path, _), spec in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        out[".".join(ref_shd._path_names(path))] = tuple(spec)
    return out, shapes


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    model = api.model_class(get_config(arch))(get_config(arch),
                                              device="meta")
    for sizes in ({"model": 16, "data": 16}, {"model": 2, "data": 2}):
        want, shapes = _ref_specs(arch, sizes)
        got = sharding.param_specs(model, axis_sizes=sizes)
        assert got == want
    # the stacked shapes are the reference's leaves, and the model holds
    # no storage
    ref_shapes = {".".join(ref_shd._path_names(p)): tuple(leaf.shape)
                  for p, leaf in jax.tree_util.tree_flatten_with_path(
                      shapes)[0]}
    assert {k: v[0] for k, v in sharding.stacked_shapes(model).items()} \
        == ref_shapes
    assert all(p.is_meta for p in model.parameters())


def test_sharding_invariants_cover_all_archs():
    """The reference's ``test_param_sharding_rules_cover_all_archs`` and
    ``test_big_weights_are_never_replicated`` on the port's specs."""
    sizes = {"model": 16, "data": 16}
    for arch in ARCHS:
        cfg = get_config(arch)
        model = api.model_class(cfg)(cfg, device="meta")
        specs = sharding.param_specs(model, axis_sizes=sizes)
        shapes = sharding.stacked_shapes(model)
        n_sharded = 0
        for path, spec in specs.items():
            shape = shapes[path][0]
            assert len(spec) == len(shape)
            for dim, entry in enumerate(spec):
                if entry is None:
                    continue
                axes = entry if isinstance(entry, tuple) else (entry,)
                n = int(np.prod([sizes[a] for a in axes]))
                assert shape[dim] % n == 0, (arch, path, spec, shape)
                n_sharded += 1
            if int(np.prod(shape)) * 2 > 32 * 2**20:
                assert any(e is not None for e in spec), (arch, path, shape)
        assert n_sharded > 0, arch


@pytest.mark.parametrize("shape", [{"data": 2, "model": 2},
                                   {"pod": 2, "data": 16, "model": 16},
                                   {"model": 4}])
def test_act_and_cache_specs_match_reference(shape):
    mesh = _comm.AbstractMesh(shape)
    ref_mesh = jax.sharding.AbstractMesh(
        tuple(shape.values()), tuple(shape),
        axis_types=(jax.sharding.AxisType.Auto,) * len(shape))
    assert sharding.dp_axes(mesh) == ref_shd.dp_axes(ref_mesh)
    specs = sharding.act_specs(mesh)
    assert specs["mesh"] is mesh
    assert set(specs) == {"mesh", "resid", "tokens", "logits"}
    dp = ref_shd.dp_axes(ref_mesh) or None
    tp = "model" if "model" in shape else None
    assert specs["resid"] == tuple(P(dp, None, None))
    assert specs["tokens"] == tuple(P(dp, None))
    assert specs["logits"] == tuple(P(dp, None, tp))
    for kind in ref_shd._CACHE_RANK:
        for batch in (1, 4, 32, 64):
            assert sharding.cache_spec(mesh, batch, kind) == tuple(
                ref_shd.cache_spec(ref_mesh, batch, kind)), (kind, batch)
    with pytest.raises(KeyError):
        sharding.cache_spec(mesh, 4, "nope")
