"""The §IV selection over ranks: ``repro_torch.core.distsort`` against the
JAX package's ``core/distsort.py`` under ``shard_map``, and
``core/topk.py:topk`` against ``jax.lax.top_k`` and the reference's ``topk``.

The reference's ``tests/test_distsort.py`` cases run through both
packages: the JAX side on 8 forced host devices, the port as 8 ``gloo``
ranks on the CPU (``tests/_torch_dist_ranks.py``; 8 banks, the same 8 as
a tuple of two mesh axes, and 4 banks on every trial).  Thresholds, masks
and minima must be equal, and equal to numpy's; the masks select exactly
k.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_ranks import distsort_inputs, run_pair
from repro.core.topk import topk as ref_topk
from repro_torch.core.topk import topk, topk_mask


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = distsort_inputs()
    port, ref = run_pair("distsort", inp, tmp_path_factory.mktemp("distsort"),
                         ndev=8)
    return inp, port, ref


def _cat(port, key, rank_order):
    return np.concatenate([port[r][key] for r in rank_order], -1)


EIGHT = list(range(8))
FOUR = [0, 1, 2, 3]          # rep 0 of the (rep 2, banks 4) mesh


@pytest.mark.parametrize("name", ["x", "ties"])
def test_topk_mask_on_8_banks(runs, name):
    inp, port, ref = runs
    want = topk_mask(torch.as_tensor(inp[name]), 13).numpy()
    for key in ("_mask8", "_mask8t"):
        got = _cat(port, name + key, EIGHT)
        assert np.array_equal(got, ref[name + "_mask8"])
        assert np.array_equal(got, want)
        assert (got.sum(-1) == 13).all()


def test_global_min_on_8_banks(runs):
    _, port, ref = runs
    for r in EIGHT:
        assert np.array_equal(port[r]["ties_min8"], ref["ties_min8"])


def test_trials_on_4_banks(runs):
    inp, port, ref = runs
    for j, (u, ks) in enumerate(zip(inp["trials"], inp["trial_ks"])):
        for k in ks:
            want = np.sort(u, axis=-1)[:, -k]
            for r in range(8):           # both rows of the mesh agree
                got = port[r][f"t{j}_kth{k}"]
                assert np.array_equal(got, ref[f"t{j}_kth{k}"]), (j, k)
                assert np.array_equal(got, want), (j, k)
        for r in range(8):
            assert np.array_equal(port[r][f"t{j}_min"], u.min(-1))
            assert np.array_equal(port[r][f"t{j}_min"], ref[f"t{j}_min"])
        mask = _cat(port, f"t{j}_mask5", FOUR)
        assert np.array_equal(mask, _cat(port, f"t{j}_mask5", [4, 5, 6, 7]))
        assert np.array_equal(mask, ref[f"t{j}_mask5"]), j
        assert (mask.sum(-1) == min(5, u.shape[-1])).all()


def test_collective_count_is_one_psum_a_plane(runs):
    # per topk_mask_sharded: 32 plane psums + the tie psum + the gather
    _, port, _ = runs
    inp = runs[0]
    n_trials = len(inp["trials"])
    kth = sum(len(ks) for ks in inp["trial_ks"])
    want = (2 * 2 * 34 + 1) + kth * 32 + n_trials * (1 + 34)
    assert all(p["collectives"] == want for p in port)


@pytest.mark.parametrize("case", ["distinct", "ties", "bf16", "int32"])
def test_topk_matches_lax_top_k(case):
    rng = np.random.default_rng(3)
    if case == "distinct":
        x = rng.normal(size=(5, 300)).astype(np.float32)
    elif case == "ties":
        x = rng.integers(0, 4, (5, 300)).astype(np.float32)
    elif case == "bf16":
        x = rng.normal(size=(3, 100)).astype(np.float32)
    else:
        x = rng.integers(-9, 9, (4, 64)).astype(np.int32)
    for k in (1, 7, x.shape[-1]):
        if case == "bf16":
            jx, tx = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(
                x).to(torch.bfloat16)
        else:
            jx, tx = jnp.asarray(x), torch.as_tensor(x)
        lv, li = jax.lax.top_k(jx, k)
        rv, ri = ref_topk(jx, k)
        v, i = topk(tx, k)
        assert v.dtype == tx.dtype and i.dtype == torch.int32
        assert np.array_equal(i.numpy(), np.asarray(li))
        assert np.array_equal(i.numpy(), np.asarray(ri))
        assert np.array_equal(v.float().numpy(),
                              np.asarray(lv.astype(jnp.float32)))
        assert np.array_equal(v.float().numpy(),
                              np.asarray(rv.astype(jnp.float32)))
