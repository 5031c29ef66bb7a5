"""Compressed data-parallel training (``repro_torch.train.loop``) against
the JAX package's ``make_dp_train_step``.

On the reference's tiny dense config (``tests/test_dist_train.py:27-33``),
from the reference's initial params (``api.init`` through
``models/convert.py``), 4 ``gloo`` ranks on the CPU against 4 forced host
devices:

  * the plain step and the step at ``compress_ratio=1.0``: loss and params
    within 2e-5 of each leaf's largest value; the grads the optimizer got
    within 1e-5 of each leaf's largest value of the mean of the
    reference's grads of the four shards, and the grad norm within 2e-5
    of that mean's (AdamW's first step moves a param by about
    ``lr * sign(g)`` whatever the size of ``g``, so the params alone would
    not see a mean left undivided); the residual exactly 0 at 1.0, and
    those grads within 1e-6 of the plain step's.  The reference's own
    grad norm is 4 times the mean's: under jax 0.9's ``shard_map`` its
    grads of the replicated params arrive summed over the ranks before
    its ``pmean`` (ROADMAP Queue 3), which the test pins;
  * at 0.05, three steps: finite, with a nonzero residual;
  * the plain step against one replica's step on the whole batch (1e-5 of
    each leaf's largest value, grads and params);
  * ``ef_topk_psum_tree`` fed exactly the reference's grads of each rank's
    shard, two rounds: residuals equal (and with them the selected set),
    reduced leaves within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist_ranks import _flat, dp_tokens, run_pair
from repro.configs.base import ModelCfg
from repro.models import api as ref_api

PARAM_REL = 2e-5       # the port's step against the reference's
GRAD_REL = 1e-5        # the reduced grads against the reference's mean
ONE_REL = 1e-5         # data parallelism against one replica
REDUCE_TOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = ModelCfg(name="tiny", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv=2, d_ff=64, vocab=96, dtype="float32")
    tokens = dp_tokens()
    params = ref_api.init(cfg, jax.random.key(0))

    def grads(i):
        shard = {"tokens": jnp.asarray(tokens[2 * i:2 * i + 2])}
        g = jax.grad(lambda p: ref_api.loss(cfg, p, shard)[0])(params)
        return jax.tree.map(np.asarray, g)

    inp = {"tokens": tokens, "params": jax.tree.map(np.asarray, params),
           "grads": [grads(i) for i in range(4)]}
    port, ref = run_pair("dp_train", inp, tmp_path_factory.mktemp("dp"),
                         ndev=4)
    shards = [_flat(g) for g in inp["grads"]]
    ref["mean_grads"] = {k: np.mean([g[k] for g in shards], axis=0,
                                    dtype=np.float64) for k in shards[0]}
    ref["mean_gnorm"] = float(np.sqrt(sum(
        np.sum(g * g) for g in ref["mean_grads"].values())))
    return port, ref


def _close(got: dict, want: dict, rel):
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(np.asarray(got[k], np.float64) - want[k]).max())
        assert err <= rel * scale, (k, err, scale)


@pytest.mark.parametrize("kind", ["plain", "comp"])
def test_dp_step_matches_reference(runs, kind):
    port, ref = runs
    for p in port:           # every replica holds the same params
        _close(p[f"{kind}_params"], ref[f"{kind}_params"], PARAM_REL)
        assert abs(p[f"{kind}_loss"] - ref[f"{kind}_loss"]) <= PARAM_REL * \
            abs(ref[f"{kind}_loss"])
        _close(p[f"{kind}_grads"], ref["mean_grads"], GRAD_REL)
        gnorm = p[f"{kind}_gnorm"]
        assert abs(gnorm - ref["mean_gnorm"]) <= PARAM_REL * ref["mean_gnorm"]
        # the reference's: the sum over the 4 ranks, not the mean
        assert abs(4 * gnorm - ref[f"{kind}_gnorm"]) <= \
            PARAM_REL * ref[f"{kind}_gnorm"]


def test_ratio_one_leaves_no_residual_and_equals_pmean(runs):
    port, ref = runs
    assert ref["comp_ef_max"] == 0.0
    for p in port:
        assert p["comp_ef_max"] == 0.0
        _close(p["comp_params"], p["plain_params"], 1e-6)
        _close(p["comp_grads"], p["plain_grads"], 1e-6)


def test_sparse_ratio_trains_and_carries_residual(runs):
    port, _ = runs
    for p in port:
        assert all(np.isfinite(p["sparse_losses"]))
        assert p["sparse_finite"]
        assert p["sparse_ef_energy"] > 0.0


def test_dp_step_equals_one_replica_on_the_whole_batch(runs):
    port, _ = runs
    for p in port:
        _close(p["plain_params"], p["one_params"], ONE_REL)
        _close(p["plain_grads"], p["one_grads"], ONE_REL)
        for m in ("loss", "gnorm"):
            assert abs(p[f"plain_{m}"] - p[f"one_{m}"]) <= ONE_REL * \
                abs(p[f"one_{m}"]), m


@pytest.mark.parametrize("rnd", [1, 2])
def test_tree_on_reference_grads(runs, rnd):
    port, ref = runs
    keys = [k for k in ref if k.startswith(f"tree{rnd}_")]
    assert keys and sorted(keys) == sorted(
        k for k in port[0] if k.startswith(f"tree{rnd}_"))
    for k in keys:
        got = np.stack([p[k] for p in port])
        if "_err." in k:
            assert np.array_equal(got, ref[k]), k
            assert (got == 0).any() and (got != 0).any()
        else:
            np.testing.assert_allclose(got, ref[k], rtol=0, atol=REDUCE_TOL)
