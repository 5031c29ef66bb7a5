"""Granite 3.0 MoE as published (``granite-3.0-3b-a800m``) on the CPU, at a
small size, against the plain float32 reference ``tests/_granite_ref.py``
(a copy of ``perfbench/reference/granite_moe.py``) on the same seeded
weights:

  * prefill and decode through the cache agree with the reference's full
    forward, with each of granite's multipliers on in turn and with all of
    them (the dropless MoE layer in every case);
  * under skewed routing the dropless layer equals the reference's, while
    the capacity path drops entries and differs;
  * the dropless layer holds the real experts only and counts every
    entry; a decode step runs on ``meta`` tensors, so it reads no value
    back to the host;
  * weights rounded through float8_e4m3fn exceed the benchmark's
    ``logit_gap`` limit; the two copies of the reference agree;
  * ``generate`` keeps the logits of the rows asked for, and the model's
    stages and counters record the call;
  * ``ARCHS`` and the reference's ``ModelCfg`` / ``MoECfg`` stay as they
    were.

Tolerance (float32): the port and the reference order their sums
differently (grouped GEMMs, SDPA, a sum over each token's k entries
against ``index_add_``), so they differ in the last bits; the largest
difference seen at this size is about 1e-6, the bound 2e-5 + 2e-5 * |x|,
as in ``test_torch_models.py``.
"""

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import _granite_ref as ref
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs.base import ModelCfg as RefModelCfg
from repro.configs.base import MoECfg as RefMoECfg
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelCfg, MoECfg
from repro_torch.configs.granite_3_0_3b_a800m import GraniteCfg
from repro_torch.models import api, convert, moe, transformer
from repro_torch.serve import generate

REPO = Path(__file__).resolve().parents[1]
BENCH_CONFIG = REPO / "perfbench" / "configs" / "granite-3.0-3b-a800m.json"
F32 = dict(rtol=2e-5, atol=2e-5)
SEED = 2**31 + 5
# the published configuration's multipliers; the cases switch them on
MULTIPLIERS = {"embedding_multiplier": 12.0, "attention_multiplier": 0.015625,
               "residual_multiplier": 0.22, "logits_scaling": 6.0}
SMALL = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
         "num_key_value_heads": 2, "intermediate_size": 32,
         "num_local_experts": 8, "num_experts_per_tok": 2, "vocab_size": 300,
         "rope_theta": 10000.0, "rms_norm_eps": 1e-6}


def hf_config(**over):
    """The reference's configuration (HF key names) at the small size:
    the multipliers neutral unless given."""
    hf = dict(SMALL, embedding_multiplier=1.0, residual_multiplier=1.0,
              logits_scaling=1.0,
              attention_multiplier=1.0 / np.sqrt(16))
    hf.update(over)
    return hf


def port_config(hf, dtype="float32"):
    """The port's configuration at ``hf``'s numbers (as the benchmark's
    program builds it)."""
    base = get_config("granite-3.0-3b-a800m")
    d, h = hf["hidden_size"], hf["num_attention_heads"]
    return dataclasses.replace(
        base, n_layers=hf["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv=hf["num_key_value_heads"], d_head=d // h,
        d_ff=hf["intermediate_size"], vocab=hf["vocab_size"],
        moe=MoECfg(n_experts=hf["num_local_experts"],
                   top_k=hf["num_experts_per_tok"],
                   d_expert=hf["intermediate_size"]),
        embedding_multiplier=hf["embedding_multiplier"],
        attention_multiplier=hf["attention_multiplier"],
        residual_multiplier=hf["residual_multiplier"],
        logits_scaling=hf["logits_scaling"], dtype=dtype)


def build(hf, seed=SEED, dtype="float32"):
    cfg = port_config(hf, dtype)
    return cfg, convert.granite_from_hf(cfg, ref.weights(hf, seed, "cpu"),
                                        device="cpu")


def reference(hf, tokens, first=0, seed=SEED):
    return ref.forward(hf, ref.Weights(hf, seed, "cpu"), tokens, first)


def close(got, want):
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), **F32)


# ------------------------------------------------------------------ forward

CASES = {**{name: {name: v} for name, v in MULTIPLIERS.items()},
         "published": MULTIPLIERS}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_the_reference(case):
    """Prefill of 10 tokens, then 3 decode steps through the cache fed the
    next tokens, against the reference's full forward over all 13."""
    hf = hf_config(**CASES[case])
    cfg, model = build(hf)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, hf["vocab_size"], (2, 13)))
    want = reference(hf, tokens, first=9)
    lg, cache = api.prefill(cfg, model, {"tokens": tokens[:, :10]})
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 3))
             for k, v in cache.items()}
    got = [lg[:, 0, :hf["vocab_size"]]]
    for i in range(10, 13):
        lg, cache = api.decode_step(cfg, model, tokens[:, i:i + 1], cache, i)
        got.append(lg[:, 0, :hf["vocab_size"]])
    close(torch.stack(got, dim=1), want)


def test_full_forward_matches_the_reference():
    hf = hf_config(**MULTIPLIERS)
    cfg, model = build(hf)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, hf["vocab_size"], (3, 17)))
    logits, _ = transformer.forward(cfg, model, {"tokens": tokens})
    close(logits[..., :hf["vocab_size"]], reference(hf, tokens))


# -------------------------------------------------------------- the layer

def skewed(hf, cfg, model, t=512):
    """Inputs shifted and one router column biased (as ``test_moe_layer
    [drops]`` does), so that expert 3 gets more than the capacity path's
    buffer holds."""
    p = model.blocks[0].moe
    p["router"][:, 3] += 0.5
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.normal(size=(2, t // 2, hf["hidden_size"]))
                        + 0.5, dtype=torch.float32)
    return p, x


def ref_layer(hf, p, x):
    """The reference's MoE layer on the port's weights, under HF's names."""
    w = {"l.block_sparse_moe.router.layer.weight": p["router"].T,
         "l.block_sparse_moe.input_linear.weight":
             p["gate_up"].transpose(1, 2),
         "l.block_sparse_moe.output_linear.weight": p["down"].transpose(1, 2)}
    return ref._moe(hf, w, "l.", x)


def capacity_params(cfg, p):
    """The same experts in the capacity path's layout: gate and up apart,
    padded to the padded expert count."""
    e, de = cfg.moe.n_experts, cfg.moe.d_expert
    pad = moe.padded_experts(cfg) - e

    def padded(t):
        return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
    return {"router": p["router"], "gate": padded(p["gate_up"][..., :de]),
            "up": padded(p["gate_up"][..., de:]), "down": padded(p["down"])}


def test_dropless_layer_under_skewed_routing():
    hf = hf_config(**MULTIPLIERS)
    cfg, model = build(hf)
    p, x = skewed(hf, cfg, model)
    t = x.shape[0] * x.shape[1]
    _, ids = moe.route_logits(cfg, p["router"], x.reshape(t, -1))
    counts = np.bincount(ids.numpy().ravel(), minlength=8)
    capacity = moe.capacity(cfg, t)
    assert counts.max() > capacity             # the capacity path drops
    want = ref_layer(hf, p, x)
    got, _ = moe.apply_moe(cfg, p, x, need_aux=False)
    close(got, want)
    cap = dataclasses.replace(cfg, dropless=False)
    dropped, _ = moe.apply_moe(cap, capacity_params(cfg, p), x,
                               need_aux=False)
    err = (dropped - want).abs().amax(-1).reshape(-1)
    assert (err > 1e-3).sum() > 0
    # what differs is exactly the dropped entries' tokens: the rest agree
    assert (err < 1e-4).sum() >= t - (counts - capacity).clip(0).sum()


def test_capacity_path_equals_dropless_without_overflow():
    """With every expert inside its capacity both paths compute the same
    layer (the capacity path's softmax over every expert, top-k and
    renormalising equals the dropless top-k then softmax)."""
    hf = hf_config(**MULTIPLIERS)
    cfg, model = build(hf)
    p = model.blocks[1].moe
    x = torch.as_tensor(np.random.default_rng(8).normal(
        size=(2, 12, hf["hidden_size"])), dtype=torch.float32)
    got, _ = moe.apply_moe(cfg, p, x, need_aux=False)
    cap = dataclasses.replace(cfg, dropless=False)
    other, _ = moe.apply_moe(cap, capacity_params(cfg, p), x,
                             need_aux=False)
    close(got, other.detach())


def test_dropless_holds_real_experts_and_counts_every_entry():
    hf = hf_config(**MULTIPLIERS)
    cfg, model = build(hf)
    p = model.blocks[0].moe
    assert set(p) == {"router", "gate_up", "down"}
    assert p["gate_up"].shape == (8, 64, 64) and p["down"].shape == (8, 32, 64)
    assert moe.padded_experts(cfg) == 16            # not what is stored
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(3, 5, 64)),
                        dtype=torch.float32)
    moe.apply_moe(cfg, p, x, need_aux=False, obs=model, span="moe.t")
    c = model.counters.section()
    assert c["moe.t.passes"] == 1 and c["moe.t.entries"] == 15 * 2
    _, ids = moe.route_logits(cfg, p["router"], x.reshape(15, 64))
    counts = np.bincount(ids.numpy().ravel(), minlength=8)
    assert c["moe.t.max_load"] == counts.max()
    assert c["moe.t.experts_hit"] == (counts > 0).sum()
    st = model.stages.section()
    assert {f"moe.t.{s}" for s in ("route", "dispatch", "experts",
                                   "combine")} <= set(st)


def test_decode_step_reads_nothing_back_to_the_host():
    """A bf16 decode step of the published layer on ``meta`` tensors, which
    hold no values: any read of a value on the host (``.item()``, a
    ``nonzero``, a Python ``if`` on a tensor) would raise."""
    cfg = port_config(hf_config(**MULTIPLIERS), "bfloat16")
    model = transformer.DecoderLM(cfg, device="meta")
    cache = api.init_cache(cfg, 2, 8, device="meta")
    token = torch.zeros((2, 1), dtype=torch.int64, device="meta")
    logits, _ = api.decode_step(cfg, model, token, cache, 3)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    assert model.counters.table["moe.decode.max_load"].device.type == "meta"


def test_prefill_on_meta_reads_nothing_back():
    cfg = port_config(hf_config(**MULTIPLIERS), "bfloat16")
    model = transformer.DecoderLM(cfg, device="meta")
    prompt = torch.zeros((2, 5), dtype=torch.int64, device="meta")
    lg, cache = api.prefill(cfg, model, {"tokens": prompt})
    assert lg.shape == (2, 1, cfg.padded_vocab)
    assert cache["k"].shape == (2, 2, 5, 2, 16)


# ---------------------------------------------------------------- the check

def test_float8_weights_exceed_the_logit_gap_limit():
    """The published configuration's ``logit_gap`` limit (the median over
    the positions of each position's gap) against the float32 port with
    every weight rounded through float8_e4m3fn, over the benchmark's
    positions (the prompt's last and each decode step's), at the published
    depth of 32 layers and vocabulary and small widths; the sound port
    reads far below it.  (The benchmark's control rounds the expert
    weights alone, whose gap adds on the card to bf16's own; in float32 at
    these widths they alone read about 0.1.)"""
    bench = json.loads(BENCH_CONFIG.read_text())
    hf = hf_config(**MULTIPLIERS, num_hidden_layers=32, hidden_size=128,
                   num_attention_heads=2, vocab_size=49155)
    cfg, model = build(hf)
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, hf["vocab_size"], (4, 24)))
    want = reference(hf, tokens, first=15)

    def gap():
        logits, _ = transformer.forward(cfg, model, {"tokens": tokens})
        got = logits[:, 15:, :hf["vocab_size"]]
        return float(((got - want).abs().amax(-1)
                      / want.pow(2).mean(-1).sqrt()).median())
    sound = gap()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.float8_e4m3fn).to(p.dtype))
    limit = bench["limits"]["logit_gap"]
    assert sound < 1e-4 < limit < gap()


def _bench_reference():
    spec = importlib.util.spec_from_file_location(
        "bench_granite_moe", REPO / "perfbench" / "reference" /
        "granite_moe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_two_reference_copies_agree():
    bench = _bench_reference()
    hf = hf_config(**MULTIPLIERS)
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, hf["vocab_size"], (2, 9)))
    a = ref.forward(hf, ref.Weights(hf, SEED, "cpu"), tokens)
    b = bench.forward(hf, bench.Weights(hf, SEED, "cpu"), tokens)
    assert torch.equal(a, b)
    names_a = [n for n, _, _ in ref.tensor_specs(hf)]
    assert names_a == [n for n, _, _ in bench.tensor_specs(hf)]
    # the reference imports nothing of the program
    tree = ast.parse(Path(bench.__file__).read_text())
    imported = {a.name.split(".")[0] for node in ast.walk(tree)
                if isinstance(node, ast.Import) for a in node.names}
    imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom)}
    assert imported == {"__future__", "contextlib", "math", "numpy",
                        "torch"}


def test_seeded_weights_are_drawn_alone_and_norms_show():
    hf = hf_config()
    specs = ref.tensor_specs(hf)
    full = dict(ref.weights(hf, SEED, "cpu"))
    w = ref.Weights(hf, SEED, "cpu")
    for name, shape, fan_in in specs[::5]:
        assert torch.equal(w[name], full[name]) and full[name].shape == shape
        if fan_in is None:
            assert (full[name] - 1).abs().max() > 0.05
    other = dict(ref.weights(hf, SEED + 1, "cpu"))
    assert not torch.equal(other[specs[0][0]], full[specs[0][0]])


# ------------------------------------------------------------- generation

def test_generate_keeps_the_rows_asked_for():
    hf = hf_config(**MULTIPLIERS)
    cfg, model = build(hf)
    prompt = torch.as_tensor(np.random.default_rng(10).integers(
        0, hf["vocab_size"], (3, 7)))
    gen = torch.Generator().manual_seed(1)
    ids, kept = generate(cfg, model, prompt, max_new_tokens=4, generator=gen,
                         temperature=0.7, top_k=50, top_p=0.9,
                         keep_rows=[2, 0])
    assert ids.shape == (3, 4) and kept.shape == (2, 5, hf["vocab_size"])
    assert kept.dtype == torch.float32
    seqs = torch.cat([prompt, ids.long()], dim=1)[[2, 0]]
    close(kept, reference(hf, seqs, first=6)[:, :5])
    again = generate(cfg, model, prompt, max_new_tokens=4,
                     generator=torch.Generator().manual_seed(1),
                     temperature=0.7, top_k=50, top_p=0.9)
    assert torch.equal(again, ids)               # the same tokens


def test_generate_records_stages_and_counters():
    hf = hf_config(**MULTIPLIERS)
    cfg, model = build(hf)
    prompt = torch.zeros((3, 7), dtype=torch.int64)
    generate(cfg, model, prompt, max_new_tokens=4)
    st = model.stages.section()
    assert st["generate.prefill"]["n"] == 1
    assert st["generate.sample"]["n"] == st["generate.decode"]["n"] == 4
    for part in ("route", "dispatch", "experts", "combine"):
        assert st[f"moe.{part}"]["n"] == 2                 # two layers
        assert st[f"moe.decode.{part}"]["n"] == 2 * 4
    assert (st["generate.decode"]["self_s"]
            < st["generate.decode"]["s"])                  # holds the MoE's
    c = model.telemetry()["counters"]
    assert c["generate.tokens"] == 12 and c["generate.decode_steps"] == 4
    assert c["moe.passes"] == 2 and c["moe.entries"] == 2 * 21 * 2
    assert c["moe.decode.passes"] == 8 and c["moe.decode.entries"] == 8 * 6


# --------------------------------------------------------------- registry

def test_archs_and_config_fields_stay_the_references():
    assert ARCHS == REF_ARCHS
    assert "granite-3.0-3b-a800m" not in ARCHS
    for arch in ARCHS:
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(ref_config(arch)))
    assert ([f.name for f in dataclasses.fields(ModelCfg)]
            == [f.name for f in dataclasses.fields(RefModelCfg)])
    assert ([f.name for f in dataclasses.fields(MoECfg)]
            == [f.name for f in dataclasses.fields(RefMoECfg)])


def test_the_published_configuration():
    cfg = get_config("granite-3.0-3b-a800m")
    assert isinstance(cfg, GraniteCfg) and cfg.dropless
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
            cfg.vocab, cfg.dtype) == (32, 1536, 24, 8, 64, 49155,
                                      "bfloat16")
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.d_expert) == (40, 8,
                                                                   512)
    assert {k: getattr(cfg, k) for k in MULTIPLIERS} == MULTIPLIERS
    stand_in = get_config("granite-moe-3b-a800m")
    assert not moe.dropless(stand_in)
    assert not hasattr(stand_in, "embedding_multiplier")
    bench = json.loads(BENCH_CONFIG.read_text())
    assert {k: bench[k] for k in MULTIPLIERS} == MULTIPLIERS
    assert bench["reduced"] == []
    smoke = get_config("granite-3.0-3b-a800m", smoke=True)
    assert smoke.dropless and smoke.embedding_multiplier == 12.0
    with pytest.raises(ValueError, match="granite-3.0-3b-a800m"):
        get_config("no-such-arch")


def test_the_stand_in_keeps_its_capacity_path():
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    model = api.init(cfg, seed=0, device="cpu")
    p = model.blocks[0].moe
    assert set(p) == {"router", "gate", "up", "down"}
    assert p["gate"].shape[0] == moe.padded_experts(cfg) == 16


def test_a_model_copies_with_its_telemetry():
    import copy
    import pickle
    hf = hf_config(**MULTIPLIERS)
    cfg, model = build(hf)
    generate(cfg, model, torch.zeros((2, 3), dtype=torch.int64),
             max_new_tokens=2)
    twin = copy.deepcopy(model)
    assert twin.telemetry() == model.telemetry()
    assert pickle.loads(pickle.dumps(model)).telemetry()["counters"] \
        == model.telemetry()["counters"]
    generate(cfg, twin, torch.zeros((2, 3), dtype=torch.int64),
             max_new_tokens=2)
    assert twin.telemetry()["counters"]["generate.tokens"] == 8
    assert model.telemetry()["counters"]["generate.tokens"] == 4
