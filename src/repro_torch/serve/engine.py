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
             frames=None, act_specs=None):
    """prompt_tokens: (B, S) -> (B, max_new_tokens) sampled ids (int32),
    on the model's device.  ``generator``: a ``torch.Generator`` on that
    device (None: one seeded with 0, as the reference's default key).
    ``frames`` (B, enc_ctx, d_model): the encoder's input, for
    ``encdec``; ``act_specs``: see the module's docstring."""
    dev = model.device
    prompt = torch.as_tensor(prompt_tokens, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    b, s = prompt.shape

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
    toks = []
    for i in range(max_new_tokens):
        tok = sample(last, generator, temperature=temperature, top_k=top_k,
                     top_p=top_p)
        lg, cache = api.decode_step(cfg, model, tok[:, None], cache, s + i,
                                    act_specs=act_specs)
        last = lg[:, 0]
        toks.append(tok)
    return torch.stack(toks, dim=1)
