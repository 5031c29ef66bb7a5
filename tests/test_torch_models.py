"""The port's dense and MoE model stack against the JAX reference.

The reference's ``api.init`` tree (numpy leaves) goes through
``repro_torch.models.convert`` into the port, and the same numpy-seeded
inputs go through both packages on the CPU:

  * blocks: norms, RoPE, ``sdpa``, ``attend`` at s = 2048 against the
    reference's blockwise path, decode attention and its kv8 variant;
  * the MoE layer: expert ids and gate values exact on the reference's
    probabilities, outputs and aux within tolerance, capacity drops;
  * prefill and 3 decode steps, logits and caches, for the six dense and
    MoE archs at smoke size (float32), and one bfloat16 variant through
    the converter.

Tolerances.  Float32 (``F32``): the two packages order their sums
differently and call different libm routines, so results differ in the
last bits; the largest difference seen at these sizes is about 5e-6 on
values up to 4, and the bound is 2e-5 + 2e-5 * |x| (about 100 ulps).
Bfloat16 (``BF16_REL``): the two round at different places; one ulp at the
largest values (up to 4) is 0.03125, 0.8 % of them, and the bound is 4 %
of the largest magnitude.  Expert ids and gate values are discrete
outputs of the same selection on the same float32 words: exact.
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
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import api, blocks, convert, moe, transformer

ARCHS = ["gemma3-4b", "command-r-35b", "deepseek-coder-33b", "qwen1.5-32b",
         "granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
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


def smoke(arch, dtype="float32"):
    return (dataclasses.replace(ref_config(arch, smoke=True), dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype))


def test_configs_equal_the_reference():
    from repro.configs import ARCHS as REF_ARCHS
    from repro_torch.configs import ARCHS as PORT_ARCHS
    assert PORT_ARCHS == REF_ARCHS
    for arch in REF_ARCHS:
        for sm in (False, True):
            assert (dataclasses.asdict(get_config(arch, smoke=sm))
                    == dataclasses.asdict(ref_config(arch, smoke=sm)))


# ---------------------------------------------------------------- blocks

def test_norms():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    sc = rng.normal(size=(64,)).astype(np.float32)
    bi = rng.normal(size=(64,)).astype(np.float32)
    close(blocks.rms_norm(t(x), t(sc)), RB.rms_norm(jnp.asarray(x),
                                                    jnp.asarray(sc)))
    close(blocks.layer_norm(t(x), t(sc), t(bi)),
          RB.layer_norm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(37) + 1000, (2, 37)).astype(np.int32)
    close(blocks.apply_rope(t(x), t(pos), theta),
          RB.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    assert np.array_equal(blocks.rope_freqs(16, theta),
                          RB.rope_freqs(16, theta))


def _qkv_inputs(seed, b, s, t_, h=4, kv=2, dh=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32),
            rng.normal(size=(b, t_, kv, dh)).astype(np.float32),
            rng.normal(size=(b, t_, kv, dh)).astype(np.float32))


def test_sdpa_with_gqa_and_mask():
    _, cfg = smoke("deepseek-coder-33b")
    q, k, v = _qkv_inputs(2, 2, 9, 9)
    mask = np.asarray(RB.causal_mask(9, 9, window=4))
    want = RB.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(mask), cfg)
    got = blocks.sdpa(t(q), t(k), t(v), torch.from_numpy(mask.copy()), cfg)
    close(got, want)
    assert torch.equal(blocks.causal_mask(9, 9, window=4),
                       torch.from_numpy(mask.copy()))


@pytest.mark.parametrize("window", [None, 5])
def test_fused_sdpa_matches_plain(window):
    """The card's path (``F.scaled_dot_product_attention`` with GQA, causal
    or a window mask) on host tensors, against the plain sdpa."""
    _, cfg = smoke("gemma3-4b")
    q, k, v = (t(a) for a in _qkv_inputs(8, 2, 11, 11))
    mask = blocks.causal_mask(11, 11, window)
    want = blocks.sdpa(q, k, v, mask, cfg)
    got = (blocks.sdpa_fused(q, k, v, causal=True) if window is None
           else blocks.sdpa_fused(q, k, v, mask[0, 0, 0]))
    close(got, want.numpy())


@pytest.mark.parametrize("window", [0, 300])
def test_attend_at_2048_matches_blockwise(window):
    """At s = 2048 the reference takes its blockwise (flash-style) path;
    the port's plain path is the direct sdpa."""
    _, cfg = smoke("gemma3-4b")
    q, k, v = _qkv_inputs(3, 1, 2048, 2048)
    assert 2048 >= RB.FLASH_MIN_SEQ
    want = RB.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.int32(window), cfg)
    close(blocks.attend(t(q), t(k), t(v), window, cfg), want)


def test_every_mask_row_sees_a_key():
    """F.scaled_dot_product_attention gives NaN for a query that sees no
    key; the causal diagonal keeps every row of every mask the port builds
    nonempty (prefill windows, decode windows)."""
    for s in (1, 7, 64):
        for w in (None, 1, 3, 64):
            assert blocks.causal_mask(s, s, w).any(-1).all()
    q, k, v = (torch.from_numpy(a) for a in _qkv_inputs(4, 1, 1, 16))
    _, cfg = smoke("gemma3-4b")
    for cache_len in (0, 5, 15):
        for w in (1, 4, 17):
            out = blocks._attend_cache(cfg, q, k, v, cache_len, w)
            assert torch.isfinite(out).all()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [None, 3])
def test_decode_attention(quant, window):
    rcfg, cfg = smoke("qwen1.5-32b")                 # with QKV bias
    rp = RB.attn_params(rcfg, jax.random.key(5))
    rng = np.random.default_rng(5)
    rp = {kk: jnp.asarray(rng.normal(size=vv.shape).astype(np.float32))
          if kk.startswith("b") else vv for kk, vv in rp.items()}
    p = {kk: t(vv) for kk, vv in rp.items()}
    b, T, n = 2, 12, 6
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((b, 1), n, np.int32)
    shape = (b, T, cfg.n_kv, cfg.head_dim)
    if quant:
        ck = rng.integers(-127, 128, shape).astype(np.int8)
        cv = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, shape[:-1]).astype(np.float32)
        want = RB.decode_attention_quant(
            rcfg, rp, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(ck),
            jnp.asarray(cv), jnp.asarray(ks), jnp.asarray(vs), n, window)
        got = blocks.decode_attention_quant(
            cfg, p, t(x), t(pos), t(ck), t(cv), t(ks), t(vs), n, window)
    else:
        ck = rng.normal(size=shape).astype(np.float32)
        cv = rng.normal(size=shape).astype(np.float32)
        want = RB.decode_attention(rcfg, rp, jnp.asarray(x), jnp.asarray(pos),
                                   jnp.asarray(ck), jnp.asarray(cv), n, window)
        got = blocks.decode_attention(cfg, p, t(x), t(pos), t(ck), t(cv), n,
                                      window)
    close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        if g.dtype == torch.int8:
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            close(g, w)


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-coder-33b"])
def test_mlp(arch):
    rcfg, cfg = smoke(arch)                          # GeGLU, SwiGLU
    rp = RB.mlp_params(rcfg, jax.random.key(6))
    x = np.random.default_rng(6).normal(size=(2, 5, 64)).astype(np.float32)
    close(blocks.apply_mlp(cfg, {kk: t(vv) for kk, vv in rp.items()}, t(x)),
          RB.apply_mlp(rcfg, rp, jnp.asarray(x)))


def test_vocab_mask():
    _, cfg = smoke("granite-moe-3b-a800m")
    full = get_config("granite-moe-3b-a800m")
    m = blocks.vocab_mask(full, torch.bfloat16)
    assert m.shape == (full.padded_vocab,) == (49408,)
    assert (m[:full.vocab] == 0).all() and (m[full.vocab:] < -1e29).all()
    assert np.array_equal(blocks.vocab_mask(cfg).numpy(),
                          np.asarray(RB.vocab_mask(cfg)))


# ---------------------------------------------------------------- MoE

@pytest.mark.parametrize("case", ["smoke", "drops", "bf16"])
def test_moe_layer(case):
    """Expert ids and gate values exact on the reference's probabilities;
    outputs within tolerance.  ``drops`` shifts the inputs and biases one
    router column mildly, so two experts get more tokens than their
    capacity while the probabilities stay far from saturation (where the
    second choice would be a tie among underflowed zeros)."""
    dtype = "bfloat16" if case == "bf16" else "float32"
    rcfg, cfg = smoke("granite-moe-3b-a800m", dtype)
    rp = ref_moe.moe_params(rcfg, jax.random.key(7))
    b, s = (2, 1024) if case == "drops" else (2, 24)
    if case == "drops":
        router = np.array(rp["router"])
        router[:, 3] += 0.1
        rp = {**rp, "router": jnp.asarray(router)}
    p = {kk: t(vv) for kk, vv in rp.items()}
    assert p["gate"].shape[0] == moe.padded_experts(cfg) == 16
    assert p["router"].dtype == torch.float32
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, s, cfg.d_model)) + (0.5 if case == "drops" else 0)
    x = jnp.asarray(x, rcfg.dtype)
    xf = x.reshape(b * s, -1)
    rw, rid, rprobs = ref_moe._route(rcfg, rp["router"], xf)
    # the port's router selection on the reference's probabilities
    vals, ids = moe.radix_topk(t(rprobs), cfg.moe.top_k, device="cpu")
    assert np.array_equal(ids.numpy(), np.asarray(rid))
    want_vals = jax.lax.top_k(rprobs, cfg.moe.top_k)[0]
    assert np.array_equal(vals.numpy(), np.asarray(want_vals))
    # the port's own routing, end to end
    w, pid, probs = moe._route(cfg, p["router"], t(xf))
    assert np.array_equal(pid.numpy(), np.asarray(rid))
    close(probs, rprobs)
    c = moe.capacity(cfg, b * s)
    assert c == ref_moe.capacity(rcfg, b * s)
    if case == "drops":
        counts = np.bincount(np.asarray(rid).ravel(), minlength=16)
        assert counts[3] > c and counts[4] > c        # overflow dropped
    want, want_aux = ref_moe.apply_moe(rcfg, rp, x)
    got, aux = moe.apply_moe(cfg, p, t(x))
    if case == "bf16":
        close_bf16(got, want)
    else:
        close(got, want)
    close(aux, want_aux)
    assert moe.apply_moe(cfg, p, t(x), need_aux=False)[1] is None


def test_moe_mesh_raises():
    _, cfg = smoke("granite-moe-3b-a800m")
    with pytest.raises(NotImplementedError, match="item 4"):
        moe.apply_moe(cfg, {}, torch.zeros(1, 1, 64), mesh=object())


def test_capacity_and_padding_at_full_size():
    for arch, e_pad in (("granite-moe-3b-a800m", 48),
                        ("qwen3-moe-235b-a22b", 128)):
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert moe.padded_experts(cfg) == ref_moe.padded_experts(rcfg) == e_pad
        for n in (4, 512, 4096, 100000):
            assert moe.capacity(cfg, n) == ref_moe.capacity(rcfg, n)
    assert moe.capacity(get_config("granite-moe-3b-a800m"), 4) == 256


# ---------------------------------------------------------------- model

@functools.lru_cache(maxsize=None)
def _ref_fns(arch, dtype):
    rcfg, _ = smoke(arch, dtype)
    pre = jax.jit(lambda p, tk: ref_api.prefill(rcfg, p, {"tokens": tk}))
    dec = jax.jit(lambda p, tk, c, n: ref_api.decode_step(rcfg, p, tk, c, n))
    return pre, dec


def _prefill_and_decode(arch, dtype, check):
    """Prefill (S = 40, past gemma3's smoke window of 32) and 3 decode
    steps through both packages; ``check(port, ref)`` on every output."""
    rcfg, cfg = smoke(arch, dtype)
    params = ref_api.init(rcfg, jax.random.key(0))
    model = convert.from_reference(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    pre, dec = _ref_fns(arch, dtype)
    rng = np.random.default_rng(0)
    b, s, n = 2, 40, 3
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    rl, rc = pre(params, jnp.asarray(toks))
    pl, pc = api.prefill(cfg, model, {"tokens": t(toks)})
    assert pl.shape == rl.shape == (b, 1, cfg.padded_vocab)
    check(pl, rl)
    for kk in ("k", "v"):
        assert pc[kk].shape == rc[kk].shape == (cfg.n_layers, b, s, cfg.n_kv,
                                                cfg.head_dim)
        check(pc[kk], rc[kk])
    rc = {kk: jnp.pad(vv, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
          for kk, vv in rc.items()}
    pc = {kk: F.pad(vv, (0, 0, 0, 0, 0, n)) for kk, vv in pc.items()}
    for i in range(n):
        tok = rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
        rl, rc = dec(params, jnp.asarray(tok), rc, jnp.int32(s + i))
        pl, pc = api.decode_step(cfg, model, t(tok), pc, s + i)
        check(pl, rl)
        check(pc["k"], rc["k"])
        check(pc["v"], rc["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    _prefill_and_decode(arch, "float32", close)


def test_bf16_through_the_converter():
    _prefill_and_decode("granite-moe-3b-a800m", "bfloat16", close_bf16)


def test_forward_matches_reference():
    rcfg, cfg = smoke("granite-moe-3b-a800m")
    params = ref_api.init(rcfg, jax.random.key(3))
    model = convert.from_reference(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))
    from repro.models import transformer as ref_tf
    rl, raux = ref_tf.forward(rcfg, params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        pl, paux = transformer.forward(cfg, model, {"tokens": t(toks)})
    close(pl, rl)
    close(paux, raux)
    assert np.array_equal(transformer.layer_windows(get_config("gemma3-4b")),
                          ref_tf.layer_windows(ref_config("gemma3-4b")))


def test_converter_rejects_a_wrong_tree():
    rcfg, cfg = smoke("gemma3-4b")
    tree = jax.tree.map(np.asarray, ref_api.init(rcfg, jax.random.key(0)))
    with pytest.raises(KeyError, match="absent"):
        convert.from_reference(cfg, {kk: vv for kk, vv in tree.items()
                                     if kk != "final_norm"}, device="cpu")
    bad = {**tree, "embed": tree["embed"][:, :8]}
    with pytest.raises(ValueError, match="embed"):
        convert.from_reference(cfg, bad, device="cpu")
    assert transformer.DecoderLM(cfg, device="cpu").embed.shape == (256, 64)


@pytest.mark.parametrize("arch", ["whisper-tiny", "rwkv6-1.6b", "hymba-1.5b",
                                  "qwen2-vl-7b"])
def test_other_families_raise(arch):
    cfg = get_config(arch, smoke=True)
    for call in (lambda: api.init(cfg, device="cpu"),
                 lambda: api.init_cache(cfg, 1, 4, device="cpu"),
                 lambda: api.prefill(cfg, None, {"tokens": [[1]]})):
        with pytest.raises(NotImplementedError, match="item 2"):
            call()
