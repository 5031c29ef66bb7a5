"""Granite 3.0 MoE served by ``repro_torch.serve.generate``: the program of
the ``granitemoe`` configurations (``"program": "graniteserve"``).

The configuration states the model under HF's key names (its
``config.json``) and names the port's configuration under ``arch``; the
program builds the port's model at exactly those numbers.  Its weights
come from the run's seed (:func:`perfbench.reference.granite_moe.weights`,
float32, cast to the configuration's dtype as the port loads them), which
reaches the program through the generator's plan: ``build`` resolves the
configuration and ``Server.start(seed)`` makes the model on the card.

The check holds what the timed path produced to the plain float32
reference (:mod:`perfbench.reference.granite_moe`), run on the card once
the program's state is freed: each call keeps the logits of one seeded
batch row (the prompt's last position and every decode step), and the
reference runs that row's prompt and generated tokens (teacher forcing)
in blocks of whole sequences.  Compared numbers:

* ``missing``: requests without an answer, and calls without kept logits;
* ``tokens``: answers that are not ``new_tokens`` ids among the real ids;
* ``sampling``: kept tokens outside the sampling rule's set, the top
  ``top_k`` of their step's kept logits over the temperature within which
  the top ``top_p`` of the mass lies (ties within ``TIE`` are given to
  the token);
* ``logit_gap``: a kept position's gap is max |port - reference| over the
  reference's root mean square at that position; the number is the
  median over every kept position of the window.
"""

from __future__ import annotations

import dataclasses
import time

from perfbench.harness import RunError

HF_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
           "num_key_value_heads", "intermediate_size", "num_local_experts",
           "num_experts_per_tok", "vocab_size", "rope_theta", "rms_norm_eps",
           "tie_word_embeddings", "embedding_multiplier",
           "attention_multiplier", "residual_multiplier", "logits_scaling",
           "torch_dtype")
SETTINGS = ("arch", "sampling", "limits") + HF_KEYS
LIMITS = ("missing", "tokens", "sampling", "logit_gap")
DTYPES = ("bfloat16", "float32")
PORT_EPS = 1e-6          # the port's RMSNorm epsilon
REF_BLOCK = 8            # sequences a reference forward
TIE = 1e-4               # logits over the temperature, and mass


def validate(config: dict) -> None:
    """Raises ValueError unless ``config`` states every setting the
    program reads, a dtype it serves and the check's limits."""
    missing = [k for k in SETTINGS if k not in config]
    if missing:
        raise ValueError(f"{config.get('name')}: no {missing}")
    if config["torch_dtype"] not in DTYPES:
        raise ValueError(f"{config['name']}: torch_dtype "
                         f"{config['torch_dtype']!r} not in {DTYPES}")
    if set(config["limits"]) != set(LIMITS):
        raise ValueError(f"{config['name']}: limits {sorted(config['limits'])}"
                         f", not {sorted(LIMITS)}")
    if not config["tie_word_embeddings"]:
        raise ValueError(f"{config['name']}: only tied embeddings")
    if config["rms_norm_eps"] != PORT_EPS:
        raise ValueError(f"{config['name']}: rms_norm_eps "
                         f"{config['rms_norm_eps']}, the port's is {PORT_EPS}")


def port_config(config: dict):
    """The port's configuration ``arch`` at the numbers ``config`` states;
    a :class:`RunError` where the program has no such configuration."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoECfg
    arch = config["arch"]
    try:
        base = get_config(arch)
    except ValueError as exc:
        raise RunError(f"the program has no configuration {arch!r} "
                       f"(repro_torch.configs.get_config: {exc})") from None
    if not getattr(base, "dropless", False):
        raise RunError(f"the program's {arch!r} has no dropless MoE layer")
    d, h = config["hidden_size"], config["num_attention_heads"]
    return dataclasses.replace(
        base, n_layers=config["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv=config["num_key_value_heads"], d_head=d // h,
        d_ff=config["intermediate_size"], vocab=config["vocab_size"],
        rope_theta=float(config["rope_theta"]), tie_embeddings=True,
        moe=MoECfg(n_experts=config["num_local_experts"],
                   top_k=config["num_experts_per_tok"],
                   d_expert=config["intermediate_size"]),
        embedding_multiplier=config["embedding_multiplier"],
        attention_multiplier=config["attention_multiplier"],
        residual_multiplier=config["residual_multiplier"],
        logits_scaling=config["logits_scaling"],
        dtype=config["torch_dtype"])


class Server:
    """The port's model of one configuration on one device, and its
    sampling settings; the model is made by :meth:`start`."""

    def __init__(self, config: dict, cfg, device: str):
        self.config, self.cfg, self.device = config, cfg, device
        self.model = None

    def start(self, seed: int) -> None:
        """The model, its weights drawn from ``seed``."""
        from perfbench.reference.granite_moe import weights
        from repro_torch.models import convert
        self.model = convert.granite_from_hf(
            self.cfg, weights(self.config, seed, self.device),
            device=self.device)

    def generate(self, prompts, new_tokens: int, generator, keep_rows):
        """One ``repro_torch.serve.generate`` call -> (ids, kept logits)."""
        from repro_torch.serve import generate
        s = self.config["sampling"]
        return generate(self.cfg, self.model, prompts,
                        max_new_tokens=new_tokens, generator=generator,
                        temperature=s["temperature"], top_k=s["top_k"],
                        top_p=s["top_p"], keep_rows=keep_rows)


def build(config: dict, device: str, cache_dir: str | None, tracer=None):
    """The server at the configuration's numbers (no model yet: the
    generator's warm-up starts it from the run's seed)."""
    validate(config)
    cfg = port_config(config)
    if cache_dir is not None:
        from repro_torch.kernels._build import set_build_dir
        set_build_dir(cache_dir)
    return Server(config, cfg, device)


def snapshot(server) -> dict:
    """The model's stage table and counters (a host synchronisation)."""
    return {"telemetry": server.model.telemetry()}


def report(server, log) -> None:
    c = server.model.telemetry()["counters"]
    log("generate: {} tokens in {} decode steps; MoE passes {} prefill, {} "
        "decode".format(c.get("generate.tokens", 0),
                        c.get("generate.decode_steps", 0),
                        c.get("moe.passes", 0), c.get("moe.decode.passes",
                                                      0)))


def _gaps(got, want):
    """Each position's max |got - want| over the RMS of ``want`` there."""
    rms = want.pow(2).mean(-1).sqrt()
    return ((got - want).abs().amax(-1) / rms).flatten()


def outside(logits, ids, sampling: dict) -> int:
    """How many of ``ids`` (n,) lie outside the sampling rule's set of
    their step's ``logits`` (n, V): the ``top_k`` largest over the
    temperature, and of those the tokens with less than ``top_p`` of the
    mass above them (as ``repro_torch.serve.sampler.sample`` draws)."""
    import torch
    lg = logits.float() / max(float(sampling["temperature"]), 1e-6)
    vals = lg.topk(min(sampling["top_k"], lg.shape[-1]), dim=-1).values
    mine = lg.gather(1, ids.long()[:, None])
    in_k = mine[:, 0] >= vals[:, -1] - TIE
    probs = torch.softmax(vals, dim=-1)
    above = (probs * (vals > mine + TIE)).sum(-1)
    in_p = above < sampling["top_p"] + TIE
    return int((~(in_k & in_p)).sum())


def check(window: dict, config: dict, marks: dict, *, seed: int, device,
          log) -> tuple[dict, dict, dict]:
    """The window's answers and kept logits against the reference."""
    import numpy as np
    import torch

    from perfbench.reference.granite_moe import Weights, forward
    n_new = window["new_tokens"]
    rule = config["sampling"]
    vocab = config["vocab_size"]

    def sound(ids):
        return ids.shape == (n_new,) and 0 <= ids.min() and ids.max() < vocab

    answers = [r for r in window["responses"] if r is not None]
    tokens = sum(not sound(np.asarray(r)) for r in answers)
    # a kept row is held to the reference when its ids are sound; its
    # logits must be there, one row a position
    kept = [k for k in window["kept"] if sound(k["ids"].numpy())]
    whole = [k for k in kept if k["logits"] is not None
             and tuple(k["logits"].shape) == (n_new + 1, vocab)]
    missing = (len(window["requests"]) - len(answers)
               + len(kept) - len(whole) + (not window["requests"]))
    kept = whole
    sampling = sum(outside(k["logits"][:n_new], k["ids"], rule)
                   for k in kept)
    t0 = time.perf_counter()
    gaps = []
    for i in range(0, len(kept), REF_BLOCK):
        block = kept[i:i + REF_BLOCK]
        seqs = torch.stack([torch.cat([k["prompt"], k["ids"].long()])
                            for k in block]).to(device)
        first = block[0]["prompt"].shape[0] - 1
        want = forward(config, Weights(config, seed, device), seqs,
                       first)[:, :n_new + 1]
        got = torch.stack([k["logits"] for k in block]).to(device)
        gaps.append(_gaps(got, want).cpu())
        del want, got
    gaps = torch.cat(gaps) if gaps else torch.zeros(1)
    gap = float(gaps.median())
    log(f"reference: {time.perf_counter() - t0:.3f} s over {len(kept)} kept "
        f"rows of {n_new + 1} positions; logit gap median {gap:.6f}, "
        f"largest {float(gaps.max()):.6f}; {sampling} tokens outside the "
        f"sampling rule")
    numbers = {"missing": int(missing), "tokens": int(tokens),
               "sampling": sampling, "logit_gap": gap}
    return numbers, dict(config["limits"]), {}


def control(server, config: dict) -> None:
    """The control of ``correct``: the expert weights (``moe.gate_up``,
    ``moe.down``), where most of the device's work lies, rounded through
    ``float8_e4m3fn``, the precision below the configuration's bf16, in
    place once set-up is done.  (The capacity dispatch at capacity factor
    1.0 drops entries of the batch's last sequence only, about 1/64 of the
    kept rows: not every window would see it.)"""
    import torch
    with torch.no_grad():
        for name, p in server.model.named_parameters():
            if name.endswith(("moe.gate_up", "moe.down")):
                p.copy_(p.to(torch.float8_e4m3fn).to(p.dtype))
