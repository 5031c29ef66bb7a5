"""The granite serving program (``programs/graniteserve.py``) and its cell
on the CPU, the configuration's widths cut here (the card runs them
whole): a sound run is correct, untraced and traced; the control is not; a
dropped logit row, a wrong token and a sampler that ignores the sampling
rule are caught; the configuration validates, and a program without the
configuration fails at once."""

import json

import numpy as np
import pytest

from _small import small_root
from perfbench import harness

SEED = 2**31 + 41
# a window of one call (a call takes longer): the kept row, and so each
# check's number, does not hang on the CPU's speed
SECONDS = 0.05
CELL = "granite3b.p512g32.b64"
CONFIG = "perfbench/configs/granite-3.0-3b-a800m.json"
# the CPU run: small widths (heads of the published 64, three query heads
# to a KV head as published), 4 experts of which 1 a token, in float32, at
# the published depth; every other number is the configuration's but the
# logit gap's limit.  The card's limit is set for bf16 at the published
# widths, where the control's float8 experts add to bf16's own rounding;
# here the sound float32 port reads about 2e-6 and the control 0.1 or so,
# and the limit lies between the two
CUT = {"hidden_size": 192, "num_attention_heads": 3, "num_key_value_heads": 1,
       "intermediate_size": 64, "num_local_experts": 4,
       "num_experts_per_tok": 1, "vocab_size": 300, "torch_dtype": "float32"}
CPU_LIMITS = {"logit_gap": 1e-3}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = small_root(tmp_path_factory.mktemp("bench"))
    path = root / CONFIG
    config = json.loads(path.read_text())
    limits = {**config["limits"], **CPU_LIMITS}
    path.write_text(json.dumps({**config, **CUT, "limits": limits}))
    return root


def program_and_config(root):
    manifest = harness.load_manifest(root)
    name = harness.find_cell(manifest, CELL)["config"]
    return (harness.load_program(root, manifest, name),
            harness.load_config(root, manifest, name))


def run(root, patch=None, trace=False):
    return harness.run_cell(root, CELL, SEED, SECONDS, trace, device="cpu",
                            patch=patch, log=lambda msg: None)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(root, trace):
    result = run(root, trace=trace)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {"missing", "tokens", "sampling",
                                     "logit_gap"}
    assert result["checks"]["sampling"]["value"] == 0
    assert 0 < result["checks"]["logit_gap"]["value"] < 1e-4
    metrics = result["metrics"]
    if trace:
        for name in ("decode_ms_per_step.granite",
                     "prefill_ms_per_call.granite",
                     "moe_host_ms_per_step.granite",
                     "expert_load_max_pct.granite",
                     "device_idle_pct.granite"):
            assert metrics[name]["value"] >= 0, name
        assert metrics["expert_load_max_pct.granite"]["value"] >= 100
    else:
        assert result["attempted"] == 3                 # one call
        assert metrics["elems_per_s"]["value"] >= 0
        assert metrics["setup_s"]["value"] > 0


def test_control_is_not_correct(root):
    program, config = program_and_config(root)
    result = run(root, patch=lambda s: program.control(s, config))
    assert not result["correct"]
    checks = result["checks"]
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]
    assert checks["missing"]["value"] == checks["tokens"]["value"] == 0
    assert checks["sampling"]["value"] == 0


def wrap_generate(server, alter):
    inner = server.generate

    def generate(*args, **kw):
        return alter(*inner(*args, **kw))
    server.generate = generate


def test_dropped_logit_row_is_caught(root):
    def drop(ids, logits):
        return ids, logits[:, :-1]
    result = run(root, patch=lambda s: wrap_generate(s, drop))
    assert not result["correct"]


def test_wrong_token_is_caught(root):
    def wrong(ids, logits):
        ids = ids.clone()
        ids[-1, 0] = 300                   # past the real ids
        return ids, logits
    result = run(root, patch=lambda s: wrap_generate(s, wrong))
    assert not result["correct"]
    assert result["checks"]["tokens"]["value"] > 0


def test_uniform_sampler_is_caught(root, monkeypatch):
    import torch

    from repro_torch.serve import engine

    def uniform(logits, generator=None, **kw):
        return torch.randint(0, 300, logits.shape[:1], generator=generator,
                             device=logits.device, dtype=torch.int32)
    monkeypatch.setattr(engine, "sample", uniform)
    result = run(root)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["sampling"]["value"] > 0
    assert checks["tokens"]["value"] == checks["missing"]["value"] == 0
    assert checks["logit_gap"]["value"] < checks["logit_gap"]["limit"]


def test_sampling_rule_bounds_the_set():
    import torch
    program = harness.load_module(harness.PKG.parent, "programs",
                                  "graniteserve")
    rule = {"temperature": 0.7, "top_k": 3, "top_p": 0.9}
    # one step: the mass over the temperature puts 0.5 on id 4, 0.3 on 1,
    # 0.15 on 2 and the rest on the others
    p = torch.tensor([0.01, 0.3, 0.15, 0.02, 0.5, 0.02])
    logits = (p.log() * 0.7)[None].expand(6, 6)
    ids = torch.arange(6)
    assert program.outside(logits, ids, rule) == 3      # 0, 3, 5
    assert program.outside(logits, ids, {**rule, "top_p": 0.7}) == 4
    assert program.outside(logits, ids, {**rule, "top_k": 6,
                                         "top_p": 1.0}) == 0


def test_config_validates(root):
    program, config = program_and_config(root)
    published = json.loads((harness.PKG / "configs" / (
        "granite-3.0-3b-a800m.json")).read_text())
    program.validate(published)
    assert published["reduced"] == []
    for key in ("arch", "limits", "hidden_size"):
        with pytest.raises(ValueError):
            program.validate({k: v for k, v in published.items()
                              if k != key})
    cfg = program.port_config(published)
    assert (cfg.n_layers, cfg.d_model, cfg.moe.n_experts, cfg.vocab,
            cfg.dtype) == (32, 1536, 40, 49155, "bfloat16")
    with pytest.raises(harness.RunError, match="no configuration"):
        program.port_config({**published, "arch": "granite-moe-3b-a800m"
                             "-absent"})
    with pytest.raises(harness.RunError, match="dropless"):
        program.port_config({**published, "arch": "granite-moe-3b-a800m"})


def test_kept_rows_hold_every_decode_step(root):
    program, config = program_and_config(root)
    mix = harness.load_mix(root, "p512g32.b64.closed")
    gen = harness.generator(root, mix["kind"])
    plan = gen.prepare(mix, config, SEED, 0.0)
    server = program.build(config, "cpu", None)

    class Hooks:
        clock = staticmethod(__import__("time").perf_counter)

        def synchronize(self):
            pass

    gen.warm(plan, server, Hooks())
    import torch
    prompts = torch.randint(0, 300, (3, 12))
    ids, kept = server.generate(prompts, 4, None, [1, 2])
    assert ids.shape == (3, 4) and kept.shape == (2, 5, 300)
    assert kept.dtype == torch.float32
    assert np.isfinite(kept.numpy()).all()
