"""The §IV bank mesh over ranks (``dist/bankmesh.py:_colskip_tile_local``,
through ``sharded_tile_fn``): one bank a ``gloo`` process on the CPU, the
manager's gates ``_comm`` collectives, as the reference's are ``psum`` and
``all_gather`` under ``shard_map``.

Four ranks, over the one-axis ``banks`` mesh and the (hosts 2, banks 2)
tuple, fuse 1, 3 and 8, both carriers, k in {0, 2, 8}, stop_after and
duplicate-heavy rows: values, order, CRs and cycles bit-identical to the
port's plain mesh (``sort_mesh_ref``) and to the JAX ``colskip_machine``
run with bank-stacked jnp hooks and assembled the same way (the
reference's own multi-device tests fail under the installed jax), and the
collectives a tile made at or under the static account
``collective_rounds(w, stop, fuse)["rounds"]``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_ranks import run_case
from repro.kernels.colskip.kernel import colskip_machine as jax_machine
from repro_torch.core.datasets import make_dataset
from repro_torch.dist.bankmesh import collective_rounds
from repro_torch.kernels.colskip.ref import sort_mesh_ref

BANKS = 4
TILES = [   # axes, dataset, b, n, w, k, stop, packed, fuse
    ("banks", "uniform", 2, 64, 32, 2, None, True, 1),
    ("hosts", "mapreduce", 2, 64, 32, 0, None, False, 1),
    ("banks", "kruskal", 2, 128, 32, 8, 16, False, 3),
    ("hosts", "clustered", 1, 96, 24, 2, None, True, 3),
    ("banks", "normal", 2, 64, 32, 2, None, False, 8),
    ("hosts", "uniform", 2, 128, 32, 0, 5, True, 8),
]


def _rows(ds, b, n, w, seed):
    x = np.stack([make_dataset(ds, n, 32, seed=seed + r)
                  for r in range(b)]).astype(np.uint32)
    return x >> np.uint32(32 - w) if w < 32 else x


@pytest.fixture(scope="module")
def runs():
    tiles = []
    for i, (axes, ds, b, n, w, k, stop, packed, fuse) in enumerate(TILES):
        tiles.append({"axes": axes, "x": _rows(ds, b, n, w, 5 + i), "w": w,
                      "k": k, "stop": stop, "packed": packed, "fuse": fuse})
    return tiles, run_case("bankmesh", {"tiles": tiles})


def _jax_mesh(x, w, k, stop, packed, fuse):
    """The JAX machine on the bank-stacked shards with jnp gates,
    assembled as the plain mesh assembles (every bank's drained elements
    at their global positions)."""
    b, n = x.shape
    n_loc = n // BANKS
    sh = x.reshape(b, BANKS, n_loc).transpose(1, 0, 2).reshape(-1, n_loc)

    def or_any(bits):
        return jnp.tile(bits.reshape(BANKS, -1, bits.shape[-1]).any(0),
                        (BANKS, 1))

    def drain_counts(m):
        per = m.reshape(BANKS, -1)
        return (jnp.tile(per.sum(0), (BANKS,)),
                (jnp.cumsum(per, 0) - per).reshape(-1))

    srt, pos, crs, drains = (np.asarray(a) for a in jax_machine(
        jnp.asarray(sh), w, k, stop, or_any=or_any,
        drain_counts=drain_counts, packed=packed, fuse=fuse))
    pos = np.where(srt, pos, stop).reshape(BANKS, b, n_loc)
    pos = pos.transpose(1, 0, 2).reshape(b, n)
    order = np.zeros((b, stop + 1), np.int64)
    np.put_along_axis(order, pos, np.broadcast_to(np.arange(n), (b, n)), 1)
    order = order[:, :stop]
    vals = np.take_along_axis(x, order, 1)
    return [vals.view(np.int32), order.astype(np.int32),
            crs[:b].astype(np.int32), (crs + drains)[:b].astype(np.int32)]


@pytest.mark.parametrize("i", range(len(TILES)))
def test_bank_mesh_over_ranks_equals_plain_and_jax(runs, i):
    tiles, ranks = runs
    t = tiles[i]
    x, stop = t["x"], t["stop"] or t["x"].shape[1]
    plain = [g.view(torch.int32) if g.dtype == torch.uint32 else g
             for g in sort_mesh_ref(torch.from_numpy(x), BANKS, t["w"],
                                    t["k"], stop, packed=t["packed"],
                                    fuse=t["fuse"])]
    jx = _jax_mesh(x, t["w"], t["k"], stop, t["packed"], t["fuse"])
    account = collective_rounds(t["w"], stop, t["fuse"])["rounds"]
    for rank in ranks:
        got = rank[i]
        for g, p, j in zip(got["outs"], plain, jx):
            assert np.array_equal(g, p.numpy())
            assert np.array_equal(g, j)
        assert 0 < got["collectives"] <= account
