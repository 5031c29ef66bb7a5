"""Batched generation engine: the prompt, then an eager decode loop.

The port of ``repro/serve/engine.py``.  The dense, MoE and VLM families
prefill the prompt; the recurrent, hybrid and encoder-decoder families
(``ssm``, ``hybrid``, ``encdec``) build their state with
``api.init_cache`` and feed the prompt one token at a time through
``decode_step`` from position 0, as the reference's ``warm`` scan does.
The reference scans its steps inside one jitted function; here Python
loops run them (no ``torch.compile``, no CUDA graphs), with no host
synchronisation inside a step, so the host can run ahead of the card.
Under ``act_specs`` (a mesh with a ``model`` axis) each rank generates
for its own data shard of the prompts, its MoE layers expert-parallel:
the ranks of one ``model`` row must hold the same prompts and seed their
generators alike, and then sample the same tokens.

The model's stage spans (``model.stages``) time the call: one
``generate.prefill`` (the warm loop, for the families that have one), and
a ``generate.sample`` and a ``generate.decode`` a step; its counters
(``model.counters``) count ``generate.tokens`` and
``generate.decode_steps``.  ``keep_rows`` keeps, on the model's device,
the float32 logits that every sampled token was drawn from, and those of
the last step, of the given batch rows: what a caller checks the timed
path by.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelCfg
from repro_torch.models import api
from .sampler import sample

WARM_FAMILIES = ("ssm", "hybrid", "encdec")


@torch.no_grad()
def generate(cfg: ModelCfg, model, prompt_tokens, *, max_new_tokens=16,
             generator=None, temperature=1.0, top_k=64, top_p=1.0,
             frames=None, act_specs=None, keep_rows=None):
    """prompt_tokens: (B, S) -> (B, max_new_tokens) sampled ids (int32),
    on the model's device.  ``generator``: a ``torch.Generator`` on that
    device (None: one seeded with 0, as the reference's default key).
    ``frames`` (B, enc_ctx, d_model): the encoder's input, for
    ``encdec``; ``act_specs``: see the module's docstring.  With
    ``keep_rows`` (R batch indices) -> (ids, logits (R, max_new_tokens +
    1, vocab) float32): the prompt's last position's logits, then each
    decode step's, over the real vocabulary."""
    dev = model.device
    stages = model.stages
    prompt = torch.as_tensor(prompt_tokens, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    b, s = prompt.shape
    rows = (None if keep_rows is None else
            torch.as_tensor(keep_rows, dtype=torch.long, device=dev))
    kept = []

    def keep(last):
        if rows is not None:
            kept.append(last[rows, :cfg.vocab].float())

    with stages.stage("generate.prefill"):
        if cfg.family in WARM_FAMILIES:
            if cfg.family == "encdec" and frames is None:
                raise ValueError("encdec: generate needs the frames")
            cache = api.init_cache(cfg, b, s + max_new_tokens, model=model,
                                   frames=frames, device=dev)
            for t in range(s):
                lg, cache = api.decode_step(cfg, model, prompt[:, t:t + 1],
                                            cache, t, act_specs=act_specs)
        else:
            lg, cache = api.prefill(cfg, model, {"tokens": prompt},
                                    act_specs=act_specs)
            # prefill emits an S-long cache; extend to max_len for decode
            # writes
            cache = {kk: F.pad(vv, (0, 0, 0, 0, 0, max_new_tokens))
                     for kk, vv in cache.items()}
        last = lg[:, -1]
        keep(last)
    toks = []
    for i in range(max_new_tokens):
        with stages.stage("generate.sample"):
            tok = sample(last, generator, temperature=temperature,
                         top_k=top_k, top_p=top_p)
        with stages.stage("generate.decode"):
            lg, cache = api.decode_step(cfg, model, tok[:, None], cache,
                                        s + i, act_specs=act_specs)
            last = lg[:, 0]
            keep(last)
        toks.append(tok)
    model.counters.add("generate.tokens", b * max_new_tokens)
    model.counters.add("generate.decode_steps", max_new_tokens)
    out = torch.stack(toks, dim=1)
    return out if rows is None else (out, torch.stack(kept, dim=1))
