"""The port's training loop against the JAX reference, on the CPU.

The ports of ``tests/test_train_and_ckpt.py``'s loop tests, each held
against the reference on the same numpy-seeded inputs where the two can
meet (weights carried across by ``convert.from_reference``):

  * ``cosine_lr``: the warm-up and the floor exact; the cosine within
    one float32 ulp of the cos term times the schedule's amplitude, plus
    one ulp of the rate (``LR_ULP``: XLA's float32 cos and torch's differ
    in the last bit on some arguments, neither correctly rounded
    everywhere);
  * ``SyntheticCorpus`` and ``LengthBucketer``: the same bytes;
  * ``adamw_update`` from the reference's params and grads, two steps,
    every slot within ``ADAMW_TOL``;
  * one ``make_train_step`` against the reference's: loss, lr and
    ``grad_norm`` within ``STEP_TOL``;
  * microbatches 2 against 1: every accumulated grad leaf (through the
    ``grad_reduce`` hook) within ``MB_GRAD_REL`` of its largest value
    (4.2e-7 seen), and the params within 2e-5 (the reference's bar, which
    one step at the default schedule cannot exceed: it moves no param by
    more than about 3e-6);
  * microbatches = 2 against the reference's microbatched step: loss,
    lr, grad norm within ``STEP_TOL`` and every accumulated grad leaf
    within ``GRAD_REL`` of its largest value (granite and hymba);
  * resume equal to an uninterrupted run within 1e-6, and the loss
    falling over 8 steps on one batch (the reference's own bars);
  * the launcher: a run, a resume, a finished resume, SIGTERM.

Tolerances: float32 in both; AdamW's update is elementwise, so its slots
differ by a few ulps of their values (1e-6 absolute); a step's loss and
grad norm by the forward and backward sums' order (as in
``tests/test_torch_loss.py``).
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data import LengthBucketer as RefBucketer
from repro.data import SyntheticCorpus as RefCorpus
from repro.models import api as ref_api
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data import LengthBucketer, SyntheticCorpus
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.train import (adamw_init, adamw_update, cosine_lr,
                               init_state, make_train_step)

LR_ULP = 2.0 ** -23
ADAMW_TOL = dict(rtol=0, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_REL = 2e-5
MB_GRAD_REL = 1e-5


def batch_of(data, step):
    return {k: torch.from_numpy(v) for k, v in data.batch(step).items()}


# ------------------------------------------------------------- schedule

@pytest.mark.parametrize("peak,warmup,total", [
    (1e-3, 10, 100), (3e-4, 100, 10_000), (1e-2, 2, 30), (3e-4, 100, 4)])
def test_cosine_lr_matches_reference(peak, warmup, total):
    for s in range(total + 3):
        want = float(np.asarray(ref_opt.cosine_lr(
            jnp.int32(s), peak=peak, warmup=warmup, total=total)))
        got = cosine_lr(s, peak=peak, warmup=warmup, total=total)
        assert got.dtype == torch.float32
        if s < warmup or s >= total:
            assert float(got) == want, s
        else:
            amplitude = (1 - 0.1) * peak * 0.5
            assert abs(float(got) - want) <= LR_ULP * (amplitude + want), s


def test_cosine_lr_schedule_shape():
    """tests/test_train_and_ckpt.py's schedule checks, in the port."""
    def lr(s):
        return float(cosine_lr(s, peak=1e-3, warmup=10, total=100))
    assert lr(0) == 0.0
    assert abs(lr(10) - 1e-3) < 1e-9
    assert lr(55) < lr(10)
    assert lr(100) >= 1e-4 * 0.99
    steps = torch.arange(5, dtype=torch.int32)
    assert cosine_lr(steps, peak=1e-3, warmup=10, total=100).shape == (5,)


# ----------------------------------------------------------------- data

@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (1000, 64, 8, 7), (49155, 128, 2, 0), (256, 32, 4, 3)])
def test_corpus_bytes_equal_reference(vocab, seq, batch, seed):
    mine, ref = (SyntheticCorpus(vocab, seq, batch, seed=seed),
                 RefCorpus(vocab, seq, batch, seed=seed))
    for step in (0, 1, 42):
        a, b = mine.batch(step)["tokens"], ref.batch(step)["tokens"]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert not np.array_equal(mine.batch(0)["tokens"],
                              mine.batch(1)["tokens"])
    it = iter(mine)
    assert np.array_equal(next(it)["tokens"], ref.batch(0)["tokens"])


def test_bucketer_bytes_equal_reference():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 100, rng.integers(3, 40)).astype(np.int32)
            for _ in range(20)] + [np.arange(90, dtype=np.int32)]
    for seq in (64, 17):
        got, want = LengthBucketer(seq).pack(docs), RefBucketer(seq).pack(docs)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert got.shape[1] == seq
        assert got.size >= sum(min(len(d), seq) for d in docs)


# ------------------------------------------------------------ optimizer

def test_adamw_moves_params_toward_gradient():
    """tests/test_train_and_ckpt.py's AdamW check, in the port."""
    params = {"w": torch.ones(4)}
    opt = adamw_init(params)
    assert opt["master"]["w"].data_ptr() != params["w"].data_ptr()
    gnorm = adamw_update(params, {"w": torch.full((4,), 2.0)}, opt, lr=0.1,
                         weight_decay=0.0)
    assert float(gnorm) == pytest.approx(4.0)
    assert (params["w"] < 1.0).all()
    assert int(opt["step"]) == 1


def test_adamw_update_matches_reference():
    arch = "granite-moe-3b-a800m"
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params = ref_api.init(rcfg, jax.random.key(0))
    data = RefCorpus(rcfg.vocab, 32, 2, seed=5)
    ref_state = {"params": params, "opt": ref_opt.adamw_init(params)}
    model = convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    named = dict(model.named_parameters())
    opt = adamw_init(named)
    for step, (lr, clip) in enumerate(((1e-3, 1.0), (5e-4, 100.0))):
        batch = {k: jnp.asarray(v) for k, v in data.batch(step).items()}
        grads = jax.grad(lambda p: ref_api.loss(rcfg, p, batch)[0])(
            ref_state["params"])
        new_params, new_opt, want_gnorm = ref_opt.adamw_update(
            grads, ref_state["opt"], lr=lr, clip=clip)
        ref_state = {"params": new_params, "opt": new_opt}
        # the reference's grads, fed to the port
        g = {n: torch.empty_like(p) for n, p in named.items()}
        convert.load_tree(cfg, g, jax.tree.map(np.asarray, grads))
        gnorm = adamw_update(named, g, opt, lr=lr, clip=clip)
        np.testing.assert_allclose(float(gnorm), float(want_gnorm),
                                   rtol=1e-6)
        assert int(opt["step"]) == int(new_opt["step"]) == step + 1
        for slot in ("master", "m", "v"):
            got = convert.to_reference(cfg, opt[slot])
            for (_, a), (_, b) in zip(
                    jax.tree_util.tree_flatten_with_path(got)[0],
                    jax.tree_util.tree_flatten_with_path(
                        jax.tree.map(np.asarray, new_opt[slot]))[0]):
                np.testing.assert_allclose(a, b, **ADAMW_TOL)
        got = convert.to_reference(cfg, model)
        for a, b in zip(jax.tree.leaves(got),
                        jax.tree.leaves(jax.tree.map(np.asarray,
                                                     new_params))):
            np.testing.assert_allclose(a, b, **ADAMW_TOL)
    assert float(gnorm) > 0


# ----------------------------------------------------------------- step

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "whisper-tiny"])
def test_train_step_matches_reference(arch):
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    data = SyntheticCorpus(cfg.vocab, 32, 4, seed=1)
    raw = data.batch(0)
    batch = launch_train.make_batch(cfg, raw["tokens"], "cpu")
    ref_state = ref_loop.init_state(rcfg, jax.random.key(0))
    _, want = jax.jit(ref_loop.make_train_step(rcfg, peak_lr=1e-3,
                                               warmup=0))(
        ref_state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    model = convert.from_reference(
        cfg, jax.tree.map(np.asarray, ref_state["params"]),
        device="cpu").trainable(True)
    state = {"model": model, "opt": adamw_init(model.named_parameters())}
    state, got = make_train_step(cfg, peak_lr=1e-3, warmup=0)(state, batch)
    assert set(got) == set(want) == {"loss", "lr", "grad_norm", "ce"}
    for k in got:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   **STEP_TOL)
    assert int(state["opt"]["step"]) == 1


def capture_grads(into):
    """A ``grad_reduce`` hook that keeps a float32 copy of every grad."""
    def reduce(grads, state):
        into.update({n: g.detach().float().clone() for n, g in grads.items()})
        return grads, {}
    return reduce


def test_microbatched_grads_match_full_batch():
    cfg = get_config("hymba-1.5b", smoke=True)
    data = SyntheticCorpus(cfg.vocab, 32, 4, seed=2)
    batch = batch_of(data, 0)
    out = {}
    for mb in (1, 2):
        grads = {}
        state = init_state(cfg, seed=0, device="cpu")
        state, m = make_train_step(cfg, microbatches=mb,
                                   grad_reduce=capture_grads(grads))(
            state, batch)
        out[mb] = (m, grads, [p.detach().clone()
                              for p in state["model"].parameters()])
    (ma, ga, pa), (mb_, gb, pb) = out[1], out[2]
    assert float(ma["loss"]) == pytest.approx(float(mb_["loss"]), rel=1e-5)
    assert float(ma["grad_norm"]) == pytest.approx(float(mb_["grad_norm"]),
                                                   rel=1e-5)
    # the reference's quirk: a microbatched step's "ce" is the total loss
    assert float(mb_["ce"]) == float(mb_["loss"])
    # the average of the two halves' grads is the whole batch's grad
    assert set(ga) == set(gb)
    for n, g in ga.items():
        assert g.abs().max() > 0, n
        err = float((gb[n] - g).abs().max())
        assert err <= MB_GRAD_REL * float(g.abs().max()), (n, err)
    # the reference's bar on the params after the step
    for a, b in zip(pa, pb):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "hymba-1.5b"])
def test_microbatched_step_matches_reference(arch):
    """microbatches = 2 against the reference's ``lax.scan`` step: its
    metrics, and its accumulated grads (each package's ``grad_reduce``
    hook hands them out).  The MoE aux loss is not linear in the batch,
    so granite's grads hold each microbatch's own routing."""
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    batch = launch_train.make_batch(
        cfg, SyntheticCorpus(cfg.vocab, 32, 4, seed=2).batch(0)["tokens"],
        "cpu")
    ref_state = ref_loop.init_state(rcfg, jax.random.key(0))
    model = convert.from_reference(
        cfg, jax.tree.map(np.asarray, ref_state["params"]),
        device="cpu").trainable(True)
    state = {"model": model, "opt": adamw_init(model.named_parameters())}
    ref_out, want = jax.jit(ref_loop.make_train_step(
        rcfg, peak_lr=1e-3, warmup=0, microbatches=2,
        grad_reduce=lambda g, s: (g, {"grads": g})))(
        ref_state, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    grads = {}
    state, got = make_train_step(cfg, peak_lr=1e-3, warmup=0, microbatches=2,
                                 grad_reduce=capture_grads(grads))(
        state, batch)
    for k in ("loss", "lr", "grad_norm", "ce"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), **STEP_TOL)
    got_tree = convert.to_reference(cfg, grads)
    want_tree = jax.tree.map(np.asarray, ref_out["grads"])
    got_l = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want_l = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert g.shape == w.shape, path
        err = np.abs(g - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def test_resume_equals_uninterrupted(tmp_path):
    cfg = get_config("rwkv6-1.6b", smoke=True)
    data = SyntheticCorpus(cfg.vocab, 16, 2, seed=3)
    step = make_train_step(cfg, peak_lr=1e-3)
    straight = init_state(cfg, seed=1, device="cpu")
    for i in range(4):
        straight, _ = step(straight, batch_of(data, i))
    s = init_state(cfg, seed=1, device="cpu")
    for i in range(2):
        s, _ = step(s, batch_of(data, i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, s, blocking=True)
    del s
    s = mgr.restore(2, init_state(cfg, seed=99, device="cpu"))
    assert int(s["opt"]["step"]) == 2
    for i in range(2, 4):
        s, _ = step(s, batch_of(data, i))
    for a, b in zip(straight["model"].parameters(), s["model"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-6)


def test_loss_decreases_over_short_run():
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    data = SyntheticCorpus(cfg.vocab, 32, 4, seed=1)
    step = make_train_step(cfg, peak_lr=1e-2, warmup=2, total_steps=30)
    state = init_state(cfg, seed=0, device="cpu")
    losses = []
    for _ in range(8):
        state, m = step(state, batch_of(data, 0))            # same batch
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_grad_reduce_hook_sees_grads_and_extends_state():
    cfg = get_config("gemma3-4b", smoke=True)
    seen = {}

    def reduce(grads, state):
        seen.update(grads)
        return {n: g * 0 for n, g in grads.items()}, {"extra": 7}

    state = init_state(cfg, seed=0, device="cpu")
    before = [p.detach().clone() for p in state["model"].parameters()]
    state, m = make_train_step(cfg, weight_decay=0.0, grad_reduce=reduce)(
        state, batch_of(SyntheticCorpus(cfg.vocab, 16, 2), 0))
    assert set(seen) == {n for n, _ in state["model"].named_parameters()}
    assert state["extra"] == 7 and float(m["grad_norm"]) == 0.0
    for a, b in zip(before, state["model"].parameters()):
        assert torch.equal(a, b)


# ------------------------------------------------------------- launcher

def test_launcher_runs_resumes_and_stops_cleanly(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    args = ["--arch", "qwen2-vl-7b", "--smoke", "--batch", "2", "--seq",
            "16", "--device", "cpu", "--ckpt_dir", ck, "--ckpt_every", "2"]
    loss = launch_train.main(args + ["--steps", "3"])
    assert np.isfinite(loss)
    assert CheckpointManager(ck).steps() == [2, 3]
    loss2 = launch_train.main(args + ["--steps", "4", "--resume"])
    assert np.isfinite(loss2)
    assert "resumed from step 3" in capsys.readouterr().out
    assert CheckpointManager(ck).steps() == [2, 3, 4]
    # a finished run: nothing to do, nothing saved (the reference raises)
    assert launch_train.main(args + ["--steps", "4", "--resume"]) is None
    assert CheckpointManager(ck).steps() == [2, 3, 4]


def test_launcher_flushes_on_sigterm(tmp_path, monkeypatch):
    ck = str(tmp_path / "ck")
    build = launch_train.make_train_step

    def make(*a, **kw):
        step = build(*a, **kw)

        def first_step_then_term(state, batch):
            out = step(state, batch)
            os.kill(os.getpid(), signal.SIGTERM)
            return out
        return first_step_then_term

    monkeypatch.setattr(launch_train, "make_train_step", make)
    before = signal.getsignal(signal.SIGTERM)
    loss = launch_train.main(["--arch", "whisper-tiny", "--smoke", "--steps",
                              "5", "--batch", "2", "--seq", "8",
                              "--microbatches", "2", "--device", "cpu",
                              "--ckpt_dir", ck])
    assert np.isfinite(loss)
    assert CheckpointManager(ck).steps() == [1]
    assert signal.getsignal(signal.SIGTERM) is before
