"""The port's ssm, hybrid, encdec and vlm families against the JAX
reference: RWKV-6, Hymba, Whisper and Qwen2-VL's M-RoPE.

The reference's ``api.init`` tree (numpy leaves) goes through
``repro_torch.models.convert`` into the port, and the same numpy-seeded
inputs go through both packages on the CPU:

  * the pieces: M-RoPE (distinct t / h / w streams, and stacked 1-D
    positions against RoPE), the sinusoids, RWKV-6's WKV scan, time mix and
    channel mix from a nonzero state, Hymba's SSM scan and Mamba branch
    from a nonzero conv tail and SSM state, Whisper's encoder and its
    cross K/V;
  * each arch at smoke size: ``api.prefill``'s logits and every state or
    cache leaf, then 3 decode steps' logits and leaves (S = 40; hymba's
    2 smoke layers are both global, so hymba also runs at 4 layers, whose
    layer 1 attends within the smoke window of 32);
  * the reference's two quirks as it has them (hymba's prefill returns a
    zero state; whisper's prefill logits carry no vocab mask);
  * the token-by-token warm-up against ``prefill`` inside the port;
  * one bfloat16 variant per family through the converter;
  * qwen2-vl's prefill with patches and ``positions3``.

Tolerances, as in ``tests/test_torch_models.py``.  Float32 (``F32``): the
two packages order their sums differently and call different libm
routines, so results differ in the last bits; the bound is 2e-5 + 2e-5 *
|x| (about 100 ulps).  Bfloat16 (``BF16_REL``): the two round at
different places; the bound is 4 % of the largest magnitude.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_config
from repro.models import api as ref_api
from repro.models import blocks as RB
from repro.models import hymba as ref_hymba
from repro.models import rwkv6 as ref_rwkv6
from repro.models import transformer as ref_tf
from repro.models import whisper as ref_whisper
from repro_torch.configs import get_config
from repro_torch.models import api, blocks, convert, hymba, rwkv6, whisper
from repro_torch.serve import engine

ARCHS = ["rwkv6-1.6b", "hymba-1.5b", "whisper-tiny", "qwen2-vl-7b"]
WARM = ["rwkv6-1.6b", "hymba-1.5b", "whisper-tiny"]
SEEDS = [0, 1]
F32 = dict(rtol=2e-5, atol=2e-5)
BF16_REL = 0.04


def t(a):
    """A numpy array (or jax array) as a writable CPU tensor."""
    return convert.to_torch(np.asarray(a))


def close(got, want, tol=F32):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def close_bf16(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_REL * np.abs(want).max(), err


def smoke(arch, dtype="float32", **kw):
    return (dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype,
                                **kw),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                                **kw))


def tree_t(tree):
    return {k: tree_t(v) if isinstance(v, dict) else t(v)
            for k, v in tree.items()}


def normal(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- M-RoPE

@pytest.mark.parametrize("seed", SEEDS)
def test_mrope_matches_reference(seed):
    _, cfg = smoke("qwen2-vl-7b")
    rng = np.random.default_rng(seed)
    x = normal(rng, 2, 11, 4, cfg.head_dim)
    pos3 = rng.integers(0, 500, (2, 11, 3)).astype(np.int32)
    assert (pos3[..., 0] != pos3[..., 1]).any()
    want = RB.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), cfg.rope_theta,
                          cfg.mrope_sections)
    got = blocks.apply_mrope(t(x), t(pos3), cfg.rope_theta,
                             cfg.mrope_sections)
    close(got, want)
    # stacked 1-D positions: M-RoPE is RoPE
    pos1 = pos3[..., 0]
    stacked = np.stack([pos1] * 3, -1)
    got = blocks.apply_mrope(t(x), t(stacked), cfg.rope_theta,
                             cfg.mrope_sections)
    assert torch.equal(got, blocks.apply_rope(t(x), t(pos1), cfg.rope_theta))
    close(got, RB.apply_rope(jnp.asarray(x), jnp.asarray(pos1),
                             cfg.rope_theta))


def test_mrope_sections_must_cover_the_head():
    with pytest.raises(ValueError, match="sum to Dh/2"):
        blocks.apply_mrope(torch.zeros(1, 1, 1, 16),
                           torch.zeros(1, 1, 3, dtype=torch.int32), 1e4,
                           (2, 2, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoids_match_reference(dtype):
    d = 64
    tdt = blocks.dtype_of(dataclasses.replace(get_config("whisper-tiny"),
                                              dtype=dtype))
    want = ref_tf._sincos(40, d).astype(jnp.dtype(dtype))
    assert np.array_equal(blocks.sincos(40, d, tdt, "cpu").float().numpy(),
                          np.asarray(want, np.float32))
    # the decode-time sinusoid, in float32, as the reference's decode steps
    i = jnp.arange(d // 2)
    for pos in (0, 7, 39, 1499):
        ang = jnp.int32(pos) / (10000 ** (2 * i / d))
        ref = jnp.concatenate([jnp.sin(ang), jnp.cos(ang)])[None, None]
        close(blocks.sincos_at(pos, d, torch.float32, "cpu"), ref)


# ---------------------------------------------------------------- RWKV-6

def _rwkv_layer(seed):
    rcfg, cfg = smoke("rwkv6-1.6b")
    lp = ref_rwkv6.layer_params(rcfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    mix = dict(lp["mix"])
    mix["u"] = jnp.asarray(normal(rng, *mix["u"].shape, scale=0.5))
    mix["gn"] = jnp.asarray(1 + normal(rng, *mix["gn"].shape, scale=0.1))
    mix["mu"] = jnp.asarray(rng.uniform(0, 1, mix["mu"].shape), jnp.float32)
    return rcfg, cfg, {**lp, "mix": mix}, rng


@pytest.mark.parametrize("seed", SEEDS)
def test_wkv_scan_from_a_state(seed):
    rng = np.random.default_rng(seed)
    b, s, h, n = 2, 9, 4, 16
    r, k, v = (normal(rng, b, s, h, n) for _ in range(3))
    w = rng.uniform(0.5, 1.0, (b, s, h, n)).astype(np.float32)
    u = normal(rng, h, n)
    st = normal(rng, b, h, n, n)
    want_o, want_s = ref_rwkv6._wkv_scan(*(jnp.asarray(a) for a in
                                           (r, k, v, w, u, st)))
    got_o, got_s = rwkv6._wkv_scan(*(t(a) for a in (r, k, v, w, u, st)))
    close(got_o, want_o)
    close(got_s, want_s)


@pytest.mark.parametrize("seed", SEEDS)
def test_time_mix_from_a_state(seed):
    rcfg, cfg, lp, rng = _rwkv_layer(seed)
    b, s, d = 2, 7, cfg.d_model
    x = normal(rng, b, s, d)
    x_prev = normal(rng, b, d)
    st = normal(rng, b, cfg.n_heads, cfg.head_dim, cfg.head_dim)
    want = ref_rwkv6._time_mix(rcfg, lp["mix"], jnp.asarray(x),
                               jnp.asarray(x_prev), jnp.asarray(st))
    got = rwkv6._time_mix(cfg, tree_t(lp["mix"]), t(x), t(x_prev), t(st))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_channel_mix_from_a_state(seed):
    rcfg, cfg, lp, rng = _rwkv_layer(seed)
    x = normal(rng, 2, 7, cfg.d_model)
    x_prev = normal(rng, 2, cfg.d_model)
    want = ref_rwkv6._channel_mix(lp["ffn"], jnp.asarray(x),
                                  jnp.asarray(x_prev))
    got = rwkv6._channel_mix(tree_t(lp["ffn"]), t(x), t(x_prev))
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------- Hymba

@pytest.mark.parametrize("seed", SEEDS)
def test_ssm_scan_from_a_state(seed):
    rng = np.random.default_rng(seed)
    b, s, di, n = 2, 9, 32, 8
    u = normal(rng, b, s, di)
    dt_ = rng.uniform(0.01, 0.5, (b, s, di)).astype(np.float32)
    bm, cm = normal(rng, b, s, n), normal(rng, b, s, n)
    a = -rng.uniform(0.1, 2.0, (di, n)).astype(np.float32)
    st = normal(rng, b, di, n)
    want = ref_hymba._ssm_scan(*(jnp.asarray(v) for v in
                                 (u, dt_, bm, cm, a, st)))
    got = hymba._ssm_scan(*(t(v) for v in (u, dt_, bm, cm, a, st)))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_mamba_branch_from_a_tail_and_state(seed):
    rcfg, cfg = smoke("hymba-1.5b")
    p = dict(ref_hymba.layer_params(rcfg, jax.random.key(seed))["ssm"])
    rng = np.random.default_rng(seed)
    p["a_log"] = jnp.asarray(normal(rng, *p["a_log"].shape, scale=0.5))
    p["dt_bias"] = jnp.asarray(normal(rng, *p["dt_bias"].shape) - 2)
    di = cfg.ssm.expand * cfg.d_model
    x = normal(rng, 2, 6, cfg.d_model)
    tail = normal(rng, 2, cfg.ssm.d_conv - 1, di)
    st = normal(rng, 2, di, cfg.ssm.state_dim)
    want = ref_hymba._mamba_branch(rcfg, p, jnp.asarray(x), jnp.asarray(tail),
                                   jnp.asarray(st))
    got = hymba._mamba_branch(cfg, tree_t(p), t(x), t(tail), t(st))
    for g, w in zip(got, want):
        close(g, w)


def test_hymba_layer_windows():
    for sm in (False, True):
        assert np.array_equal(
            hymba.layer_windows(get_config("hymba-1.5b", smoke=sm)),
            ref_hymba.layer_windows(ref_config("hymba-1.5b", smoke=sm)))
    w = hymba.layer_windows(get_config("hymba-1.5b"))
    assert list(np.flatnonzero(w == 0)) == [0, 16, 31] and w.max() == 1024


# ---------------------------------------------------------------- Whisper

def _frames(cfg, b, seed):
    return normal(np.random.default_rng(seed), b, cfg.enc_ctx, cfg.d_model)


@pytest.mark.parametrize("seed", SEEDS)
def test_whisper_encoder_and_cross_kv(seed):
    rcfg, cfg = smoke("whisper-tiny")
    params = ref_api.init(rcfg, jax.random.key(seed))
    model = convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    fr = _frames(cfg, 2, seed)
    close(whisper.encode(cfg, model, t(fr)),
          ref_whisper.encode(rcfg, params, jnp.asarray(fr)))
    want = ref_whisper.init_cache(rcfg, params, jnp.asarray(fr), 12)
    with torch.no_grad():
        got = api.init_cache(cfg, 2, 12, model=model, frames=t(fr))
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for kk in want:
        assert got[kk].shape == want[kk].shape
        close(got[kk], want[kk])
    assert not got["k"].any() and not got["v"].any()


# ---------------------------------------------------------------- models

@functools.lru_cache(maxsize=None)
def _ref_fns(arch, dtype, overrides=()):
    rcfg, _ = smoke(arch, dtype, **dict(overrides))
    pre = jax.jit(lambda p, b: ref_api.prefill(rcfg, p, b))
    dec = jax.jit(lambda p, tk, c, n: ref_api.decode_step(rcfg, p, tk, c, n))
    return pre, dec


def _models(arch, dtype="float32", seed=0, **kw):
    rcfg, cfg = smoke(arch, dtype, **kw)
    params = ref_api.init(rcfg, jax.random.key(seed))
    model = convert.from_reference(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return rcfg, cfg, params, model


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = _frames(cfg, b, seed)
    return batch


def _extend(cache, n, pad):
    """A prefill's cache with ``n`` more self-attention slots (``k``, ``v``);
    recurrent and cross-attention leaves stay as they are."""
    return {kk: pad(vv, n) if kk in ("k", "v") else vv
            for kk, vv in cache.items()}


def _prefill_and_decode(arch, dtype, check, **kw):
    """Prefill (S = 40) and 3 decode steps through both packages;
    ``check(port, ref)`` on the logits and every state leaf."""
    rcfg, cfg, params, model = _models(arch, dtype, **kw)
    pre, dec = _ref_fns(arch, dtype, tuple(sorted(kw.items())))
    b, s, n = 2, 40, 3
    batch = _batch(cfg, b, s, 0)
    rl, rc = pre(params, {kk: jnp.asarray(v) for kk, v in batch.items()})
    pl, pc = api.prefill(cfg, model, {kk: t(v) for kk, v in batch.items()})
    assert pl.shape == rl.shape == (b, 1, cfg.padded_vocab)
    check(pl, rl)
    assert set(pc) == set(rc)
    for kk in rc:
        assert pc[kk].shape == rc[kk].shape and (
            pc[kk].dtype == convert.to_torch(np.asarray(rc[kk])).dtype), kk
        check(pc[kk], rc[kk])
    rc = _extend(rc, n, lambda v, m: jnp.pad(
        v, ((0, 0), (0, 0), (0, m), (0, 0), (0, 0))))
    pc = _extend(pc, n, lambda v, m: F.pad(v, (0, 0, 0, 0, 0, m)))
    rng = np.random.default_rng(1)
    for i in range(n):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        rl, rc = dec(params, jnp.asarray(tok), rc, jnp.int32(s + i))
        pl, pc = api.decode_step(cfg, model, t(tok), pc, s + i)
        check(pl, rl)
        for kk in rc:
            check(pc[kk], rc[kk])
    return pl, pc


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    _prefill_and_decode(arch, "float32", close)


def test_hymba_windowed_layer_matches_reference():
    """The smoke config's 2 layers are all global ({0, L/2, L-1}); at 4
    layers, layer 1 attends within the smoke window of 32, which S = 40
    passes."""
    _, cfg = smoke("hymba-1.5b", n_layers=4)
    assert list(hymba.layer_windows(cfg)) == [0, 32, 0, 0]
    _prefill_and_decode("hymba-1.5b", "float32", close, n_layers=4)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_through_the_converter(arch):
    _prefill_and_decode(arch, "bfloat16", close_bf16)


def test_hymba_prefill_returns_a_zero_state():
    """The reference's quirk: hybrid prefill gives forward's last logits and
    ``init_state`` of the prompt's length, all zeros."""
    rcfg, cfg, params, model = _models("hymba-1.5b")
    batch = _batch(cfg, 2, 12, 3)
    rl, rc = ref_api.prefill(rcfg, params,
                             {"tokens": jnp.asarray(batch["tokens"])})
    pl, pc = api.prefill(cfg, model, {"tokens": t(batch["tokens"])})
    close(pl, rl)
    for kk in ("k", "v", "conv", "ssm"):
        assert pc[kk].shape == rc[kk].shape
        assert not pc[kk].any() and not np.asarray(rc[kk]).any(), kk
    assert pc["k"].shape[2] == 12


def test_whisper_prefill_logits_are_unmasked():
    """The reference's quirk: whisper's forward (and so its prefill) has no
    vocab mask, its decode step has.  A vocab of 250 pads to 256: the six
    padding ids carry raw logits after prefill, -1e30 after a decode
    step."""
    rcfg, cfg, params, model = _models("whisper-tiny", vocab=250)
    assert cfg.padded_vocab == 256
    pre, dec = _ref_fns("whisper-tiny", "float32", (("vocab", 250),))
    batch = _batch(cfg, 2, 10, 4)
    rl, rc = pre(params, {kk: jnp.asarray(v) for kk, v in batch.items()})
    pl, pc = api.prefill(cfg, model, {kk: t(v) for kk, v in batch.items()})
    close(pl, rl)
    assert (pl[..., 250:].abs() < 1e3).all()           # raw, not -1e30
    assert np.abs(np.asarray(rl[..., 250:])).max() < 1e3
    pc = _extend(pc, 1, lambda v, m: F.pad(v, (0, 0, 0, 0, 0, m)))
    tok = np.ones((2, 1), np.int32)
    dl, _ = api.decode_step(cfg, model, t(tok), pc, 10)
    assert (dl[..., 250:] < -1e29).all()


@pytest.mark.parametrize("arch,layers", [(a, None) for a in WARM]
                         + [("hymba-1.5b", 4)])
def test_warmup_equals_prefill(arch, layers):
    """The engine's path for these families (``init_cache``, then the
    prompt token by token through ``decode_step`` from position 0) ends on
    the logits of ``prefill`` (S = 40; hymba at 4 layers has a windowed
    layer, window 32); RWKV-6's state after the prompt is prefill's too."""
    _, cfg, _, model = _models(arch, **({"n_layers": layers} if layers
                                        else {}))
    b, s = 2, 40
    batch = {kk: t(v) for kk, v in _batch(cfg, b, s, 5).items()}
    pl, pc = api.prefill(cfg, model, batch)
    cache = api.init_cache(cfg, b, s, model=model,
                           frames=batch.get("frames"), device="cpu")
    for i in range(s):
        lg, cache = api.decode_step(cfg, model, batch["tokens"][:, i:i + 1],
                                    cache, i)
    close(lg[..., :cfg.vocab], pl[..., :cfg.vocab].numpy())
    if arch == "rwkv6-1.6b":
        for kk in pc:
            close(cache[kk], pc[kk].numpy())
    assert engine.WARM_FAMILIES == ("ssm", "hybrid", "encdec")


def test_vlm_prefill_with_patches_and_positions3():
    """256 / 32 = 8 smoke patches on a 2 x 4 grid at (0, i // 4, i % 4), then
    text token j at 4 + j on all three streams."""
    rcfg, cfg, params, model = _models("qwen2-vl-7b", seed=2)
    rng = np.random.default_rng(2)
    b, p, s = 2, cfg.vision_patches, 12
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    patches = normal(rng, b, p, cfg.d_model)
    grid = np.stack([np.zeros(p), np.arange(p) // 4, np.arange(p) % 4], -1)
    text = np.repeat(4 + np.arange(s)[:, None], 3, -1)
    pos3 = np.broadcast_to(np.concatenate([grid, text])[None],
                           (b, p + s, 3)).astype(np.int32)
    batch = {"tokens": toks, "patches": patches, "positions3": pos3}
    rl, rc = ref_api.prefill(rcfg, params,
                             {kk: jnp.asarray(v) for kk, v in batch.items()})
    pl, pc = api.prefill(cfg, model, {kk: t(v) for kk, v in batch.items()})
    close(pl, rl)
    for kk in ("k", "v"):
        assert pc[kk].shape[2] == p + s
        close(pc[kk], rc[kk])
    # the sections act: 1-D positions give other logits
    p1, _ = api.prefill(cfg, model, {"tokens": t(toks),
                                     "patches": t(patches)})
    assert not torch.allclose(p1, pl, **F32)
