"""The traffic generators: the same seed gives the same inputs, another
seed the same work in another order."""

import json

import numpy as np
import pytest

from _small import REPO
from perfbench.traffic import closed_loop, datasets, open_loop

CONFIG = json.loads(
    (REPO / "perfbench/configs/colskip-n1024-w32-k2.json").read_text())
SEED = 2**31 + 12345          # seeds reach past 32 signed bits


def mix(name):
    return json.loads((REPO / f"perfbench/traffic/{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(datasets.DATASETS))
def test_datasets_are_seeded(name):
    a = datasets.dataset(name, np.random.default_rng(SEED), 1024)
    b = datasets.dataset(name, np.random.default_rng(SEED), 1024)
    c = datasets.dataset(name, np.random.default_rng(SEED + 1), 1024)
    assert a.dtype == np.uint32 and a.shape == (1024,)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
def test_launcher_payloads_are_seeded(dtype):
    a = datasets.launcher_payload(np.random.default_rng(SEED), 100, dtype)
    b = datasets.launcher_payload(np.random.default_rng(SEED), 100, dtype)
    assert a.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["uniform1024.backlog",
                                  "mapreduce1024.backlog"])
def test_closed_loop_pool(name):
    m = dict(mix(name), pool=16)
    a = closed_loop.prepare(m, CONFIG, SEED, 10)
    b = closed_loop.prepare(m, CONFIG, SEED, 10)
    c = closed_loop.prepare(m, CONFIG, SEED + 1, 10)
    for key in ("doubled", "pairs", "ops"):
        np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a["doubled"], c["doubled"])
    # (base, offset) pairs never repeat: no payload is sent twice
    assert len(set(a["pairs"].tolist())) == a["pairs"].size
    payloads = {closed_loop._payload(a, i).tobytes() for i in range(2000)}
    assert len(payloads) == 2000
    # each batch holds every op in its exact share
    batch = a["batch"]
    for lo in range(0, 1024, batch):
        ops = list(a["ops"][lo:lo + batch])
        assert ops.count("sort") == ops.count("argsort") == batch // 2


def test_open_loop_same_work_every_seed():
    m = mix("mixed.poisson")
    a = open_loop.prepare(m, CONFIG, SEED, 4)
    b = open_loop.prepare(m, CONFIG, SEED, 4)
    c = open_loop.prepare(m, CONFIG, SEED + 7, 4)
    total = int(round(m["rate_per_s"] * 4))
    assert len(a["ops"]) == total
    np.testing.assert_array_equal(a["arrivals"], b["arrivals"])
    for i in range(0, total, 97):
        np.testing.assert_array_equal(a["payloads"][i], b["payloads"][i])
    # another seed: the same gaps, and each op the same lengths and k,
    # in another order
    np.testing.assert_array_equal(np.sort(a["gaps"]), np.sort(c["gaps"]))
    assert not np.array_equal(a["arrivals"], c["arrivals"])
    for op in m["ops"]:
        for key in ("n", "k"):
            np.testing.assert_array_equal(np.sort(a[key][a["ops"] == op]),
                                          np.sort(c[key][c["ops"] == op]))
    assert a["arrivals"][-1] < 4
    assert a["n"].min() >= 64 and a["n"].max() <= 2048
    sel = np.isin(a["ops"], ["topk", "kmin"])
    assert (a["k"][sel] >= 1).all()
    assert (a["k"][sel] <= np.minimum(64, a["n"][sel])).all()
    assert (a["k"][~sel] == 0).all()
