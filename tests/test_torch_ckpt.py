"""The port's checkpoints against the JAX reference's, on the CPU.

The ports of ``tests/test_train_and_ckpt.py``'s checkpoint tests (keep
policy, ``.tmp`` cleanup, round trip), and the format held across the
packages: one ``arrays.npz`` keyed by the reference's stacked tree paths
plus ``manifest.json``.

  * a float32 checkpoint written by either package restores in the
    other, every leaf equal (exact: the bytes are carried, not computed);
  * a bf16 checkpoint written by the reference (its bf16 leaves are
    ``|V2`` raw bits in the ``.npz``) restores in the port bit for bit.
    The reference cannot restore it itself: ``CheckpointManager.restore``
    fails on ``arr.astype(bfloat16)`` with "No cast function available"
    (ROADMAP Queue 3); nothing here depends on that;
  * the port writes bf16 leaves in the same ``|V2`` form and reads them
    back bit for bit;
  * ``save`` snapshots the state: training on while the write is in
    flight changes nothing on disk.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as RefManager
from repro.configs import get_config as ref_config
from repro.data import SyntheticCorpus as RefCorpus
from repro.train import loop as ref_loop
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.manager import reference_tree
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus
from repro_torch.train import init_state, make_train_step


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], want[key]
        assert g.shape == w.shape, key
        # bf16: ml_dtypes' in the reference's tree, |V2 bits in the port's
        g, w = bits(g), bits(w)
        assert g.dtype == w.dtype, key
        assert np.array_equal(g, w), key


def bits(a):
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return a.view(np.int16)
    return a


def trained_state(arch, seed=0):
    cfg = get_config(arch, smoke=True)
    state = init_state(cfg, seed=seed, device="cpu")
    data = SyntheticCorpus(cfg.vocab, 16, 2, seed=seed)
    batch = {k: torch.from_numpy(v) for k, v in data.batch(0).items()}
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((2, cfg.enc_ctx, cfg.d_model))
    state, _ = make_train_step(cfg, peak_lr=1e-2, warmup=0)(state, batch)
    return cfg, state


def test_checkpoint_roundtrip_and_resume(tmp_path):
    cfg, state = trained_state("whisper-tiny")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, state, blocking=True)
    mgr.save(10, state, blocking=True)
    assert mgr.latest_step() == 10
    restored = mgr.restore(10, init_state(cfg, seed=7, device="cpu"))
    assert_trees_equal(reference_tree(restored), reference_tree(state))
    assert int(restored["opt"]["step"]) == 1


def test_checkpoint_gc_and_tmp_cleanup(tmp_path):
    cfg = get_config("whisper-tiny", smoke=True)
    state = init_state(cfg, seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, state, blocking=True)
    assert mgr.steps() == [2, 3]          # keep policy
    os.makedirs(tmp_path / "step_9.tmp")  # an interrupted write
    mgr2 = CheckpointManager(str(tmp_path))
    assert not (tmp_path / "step_9.tmp").exists()
    assert mgr2.latest_step() == 3
    assert CheckpointManager(str(tmp_path / "empty")).latest_step() is None


def test_save_snapshots_the_state_before_writing(tmp_path):
    cfg, state = trained_state("gemma3-4b")
    want = reference_tree(state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)                    # async
    with torch.no_grad():
        for p in state["model"].parameters():
            p.add_(1.0)
        for m in state["opt"]["m"].values():
            m.add_(1.0)
    mgr.wait()
    restored = mgr.restore(1, init_state(cfg, seed=3, device="cpu"))
    assert_trees_equal(reference_tree(restored), want)


@pytest.mark.parametrize("arch", ["whisper-tiny", "granite-moe-3b-a800m"])
def test_reference_checkpoint_restores_in_port(arch, tmp_path):
    rcfg = ref_config(arch, smoke=True)
    ref_state = ref_loop.init_state(rcfg, jax.random.key(0))
    data = RefCorpus(rcfg.vocab, 16, 2, seed=0)
    batch = {k: jax.numpy.asarray(v) for k, v in data.batch(0).items()}
    if rcfg.family == "encdec":
        batch["frames"] = jax.numpy.zeros((2, rcfg.enc_ctx, rcfg.d_model))
    ref_state, _ = jax.jit(ref_loop.make_train_step(rcfg, warmup=0))(
        ref_state, batch)
    RefManager(str(tmp_path)).save(1, ref_state, blocking=True)
    cfg = get_config(arch, smoke=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    state = mgr.restore(1, init_state(cfg, seed=5, device="cpu"))
    assert_trees_equal(reference_tree(state), ref_state)


@pytest.mark.parametrize("arch", ["whisper-tiny", "granite-moe-3b-a800m"])
def test_port_checkpoint_restores_in_reference(arch, tmp_path):
    cfg, state = trained_state(arch)
    CheckpointManager(str(tmp_path)).save(1, state, blocking=True)
    rcfg = ref_config(arch, smoke=True)
    ref_mgr = RefManager(str(tmp_path))
    assert ref_mgr.latest_step() == 1
    like = ref_loop.init_state(rcfg, jax.random.key(9))
    restored = ref_mgr.restore(1, like)
    assert_trees_equal(restored, reference_tree(state))
    with open(tmp_path / "step_1" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest == {"step": 1, "keys": sorted(flat_keys(like))}


def flat_keys(tree):
    return ["/".join(str(p.key) for p in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_reference_bf16_checkpoint_restores_in_port_bit_exact(tmp_path):
    arch = "granite-moe-3b-a800m"
    rcfg = dataclasses.replace(ref_config(arch, smoke=True),
                               dtype="bfloat16")
    ref_state = ref_loop.init_state(rcfg, jax.random.key(0))
    RefManager(str(tmp_path)).save(3, ref_state, blocking=True)
    with np.load(tmp_path / "step_3" / "arrays.npz") as arrays:
        assert arrays["params/embed"].dtype == np.dtype("V2")
        assert arrays["params/layers/moe/router"].dtype == np.float32
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    state = CheckpointManager(str(tmp_path)).restore(
        3, init_state(cfg, seed=1, device="cpu"))
    assert state["model"].embed.dtype == torch.bfloat16
    assert_trees_equal(reference_tree(state), ref_state)


def test_port_bf16_checkpoint_round_trips_bit_exact(tmp_path):
    cfg = dataclasses.replace(get_config("hymba-1.5b", smoke=True),
                              dtype="bfloat16")
    state = init_state(cfg, seed=2, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state, blocking=True)
    with np.load(tmp_path / "step_4" / "arrays.npz") as arrays:
        assert arrays["params/embed"].dtype == np.dtype("V2")
        assert arrays["params/layers/beta"].dtype == np.float32
        assert arrays["opt/master/embed"].dtype == np.float32
    restored = mgr.restore(4, init_state(cfg, seed=8, device="cpu"))
    for a, b in zip(state["model"].parameters(),
                    restored["model"].parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert_trees_equal(reference_tree(restored), reference_tree(state))
