"""The port's serving path (``repro_torch.serve``) for the dense and MoE
families: the properties of ``tests/test_serving.py`` on the port, and a
greedy decode loop whose tokens equal the reference's.

Torch cannot replay jax's random streams, so sampled tokens are held to
properties (top-k set, top-p prune, temperature limit, range) and to
determinism under a seeded ``torch.Generator``.  Greedy tokens are
discrete, so they are held to the reference's exactly, on converted
weights; the test first asserts the reference's top-2 margin is at least
1e-3 at every step, about 300 times the float32 logit differences between
the packages (``tests/test_torch_models.py``), so a near tie cannot flip a
token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_config
from repro.models import api as ref_api
from repro.serve.sampler import greedy as ref_greedy
from repro_torch.configs import get_config
from repro_torch.models import api, convert
from repro_torch.serve import generate, greedy, sample

MARGIN = 1e-3


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_greedy_is_argmax():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(5, 1000)).astype(np.float32))
    assert torch.equal(greedy(logits).long(), logits.argmax(-1))


def test_sample_respects_top_k():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(8, 512)).astype(np.float32))
    k = 4
    topk_sets = torch.topk(logits, k).indices
    for seed in range(5):
        toks = sample(logits, _gen(seed), top_k=k)
        assert toks.dtype == torch.int32
        for b in range(8):
            assert toks[b] in topk_sets[b]


def test_sample_top_p_prunes_tail():
    # one dominant logit -> top_p=0.5 must always return it
    logits = torch.full((2, 100), -10.0)
    logits[:, 7] = 10.0
    for seed in range(5):
        toks = sample(logits, _gen(seed), top_k=16, top_p=0.5)
        assert (toks == 7).all()


def test_sample_top_p_keeps_the_nucleus():
    # mass 0.5, 0.3, 0.2 over ids 3, 9, 4: top_p = 0.7 keeps {3, 9} only
    p = torch.full((1, 50), 1e-12)
    p[0, 3], p[0, 9], p[0, 4] = 0.5, 0.3, 0.2
    seen = {int(sample(p.log(), _gen(s), top_k=8, top_p=0.7)[0])
            for s in range(40)}
    assert seen == {3, 9}


def test_sample_temperature_zero_limit():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(size=(4, 64)).astype(np.float32))
    toks = sample(logits, _gen(0), temperature=1e-6)
    assert torch.equal(toks.long(), logits.argmax(-1))


def test_sample_draws_by_probability():
    # two ids at probability 0.75 and 0.25: 2000 draws within 4 sigma
    logits = torch.full((2000, 10), -1e9)
    logits[:, 2], logits[:, 5] = np.log(0.75), np.log(0.25)
    toks = sample(logits, _gen(3), top_k=4)
    share = float((toks == 2).float().mean())
    assert abs(share - 0.75) < 4 * np.sqrt(0.75 * 0.25 / 2000)
    assert set(toks.tolist()) == {2, 5}


@pytest.mark.parametrize("arch", ["gemma3-4b", "granite-moe-3b-a800m"])
def test_generate_end_to_end(arch):
    cfg = get_config(arch, smoke=True)
    model = api.init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)))
    out = generate(cfg, model, prompts, max_new_tokens=4, generator=_gen(1),
                   top_k=8)
    assert out.shape == (2, 4)
    assert ((out >= 0) & (out < cfg.padded_vocab)).all()
    # vocab padding rows are masked to -1e30 and must never be sampled
    assert (out < cfg.vocab).all()


def test_padding_ids_are_never_sampled():
    """A vocab of 250 pads to 256: the six padding ids carry the -1e30
    mask and are never drawn, even where their raw logits lead."""
    import dataclasses
    cfg = dataclasses.replace(get_config("gemma3-4b", smoke=True), vocab=250)
    model = api.init(cfg, seed=0, device="cpu")
    prompts = torch.ones((2, 4), dtype=torch.int64)
    logits, _ = api.prefill(cfg, model, {"tokens": prompts})
    lead = logits[0, 0, :250].argmax()
    assert logits[0, 0, lead] > 0
    with torch.no_grad():   # tied head: the padding rows' raw logits are 3x
        model.embed[250:] = 3 * model.embed[lead]      # the leader's
    logits, _ = api.prefill(cfg, model, {"tokens": prompts})
    assert (logits[..., 250:] < -1e29).all()
    out = generate(cfg, model, prompts, max_new_tokens=6, generator=_gen(2),
                   top_k=64)
    assert (out < 250).all()


def test_generate_deterministic_given_generator():
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    model = api.init(cfg, seed=0, device="cpu")
    prompts = torch.ones((2, 4), dtype=torch.int32)
    a = generate(cfg, model, prompts, max_new_tokens=6, generator=_gen(7))
    b = generate(cfg, model, prompts, max_new_tokens=6, generator=_gen(7))
    c = generate(cfg, model, prompts, max_new_tokens=6, generator=_gen(8))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_kv8_quantized_cache_matches_plain():
    """int8 KV cache decode (kv8 serving variant): <2% relative logit error
    against the plain cache, as the reference's test holds it."""
    cfg = get_config("gemma3-4b", smoke=True)
    model = api.init(cfg, seed=0, device="cpu")
    b, T = 2, 16
    cache = api.init_cache(cfg, b, T, device="cpu")
    L = cfg.n_layers
    qcache = {
        "k": torch.zeros((L, b, T, cfg.n_kv, cfg.head_dim), dtype=torch.int8),
        "v": torch.zeros((L, b, T, cfg.n_kv, cfg.head_dim), dtype=torch.int8),
        "k_scale": torch.zeros((L, b, T, cfg.n_kv)),
        "v_scale": torch.zeros((L, b, T, cfg.n_kv)),
    }
    tok = torch.ones((b, 1), dtype=torch.int32)
    for step in range(3):
        l1, cache = api.decode_step(cfg, model, tok, cache, step)
        l2, qcache = api.decode_step(cfg, model, tok, qcache, step)
        d = (l1 - l2).abs().max()
        assert d / l1.abs().max() < 0.02, (step, float(d))
    assert qcache["k"].abs().max() == 127            # absmax-quantised


@pytest.mark.parametrize("arch", ["gemma3-4b", "granite-moe-3b-a800m"])
def test_greedy_decode_equals_reference(arch):
    rcfg, cfg = ref_config(arch, smoke=True), get_config(arch, smoke=True)
    params = ref_api.init(rcfg, jax.random.key(0))
    model = convert.from_reference(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(4)
    b, s, n = 2, 40, 8                   # past gemma3's smoke window of 32
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    rl, rc = ref_api.prefill(rcfg, params, {"tokens": jnp.asarray(toks)})
    rc = {k: jnp.pad(v, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
          for k, v in rc.items()}
    pl, pc = api.prefill(cfg, model, {"tokens": torch.from_numpy(toks)})
    pc = {k: F.pad(v, (0, 0, 0, 0, 0, n)) for k, v in pc.items()}
    dec = jax.jit(lambda p, tk, c, i: ref_api.decode_step(rcfg, p, tk, c, i))
    ref_toks, port_toks = [], []
    for i in range(n):
        top2 = np.sort(np.asarray(rl[:, -1], np.float32), -1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0] >= MARGIN).all(), (i, top2)
        rt, pt = ref_greedy(rl[:, -1]), greedy(pl[:, -1])
        ref_toks.append(np.asarray(rt))
        port_toks.append(pt.numpy())
        rl, rc = dec(params, rt[:, None], rc, jnp.int32(s + i))
        pl, pc = api.decode_step(cfg, model, pt[:, None], pc, s + i)
    assert np.array_equal(np.stack(port_toks), np.stack(ref_toks))


def test_launcher_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt_len", "8", "--new_tokens", "4"])
    assert out.shape == (2, 4)
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 2"):
        serve.main(["--smoke", "--device", "cpu", "--arch", "hymba-1.5b"])


def test_batched_serving_example_on_cpu(capsys):
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "examples" /
            "torch" / "serve_batched.py")
    spec = importlib.util.spec_from_file_location("serve_batched", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    assert "batch=8 prompt=16 new=24 on cpu" in capsys.readouterr().out
