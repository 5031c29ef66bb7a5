"""Batched generation engine: prefill, then an eager decode loop.

The port of ``repro/serve/engine.py`` for the dense and MoE families.  The
reference scans its decode steps inside one jitted function; here a Python
loop runs them (no ``torch.compile``, no CUDA graphs), with no host
synchronisation inside a step, so the host can run ahead of the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelCfg
from repro_torch.models import api
from repro_torch.models.transformer import DecoderLM, check_family
from .sampler import sample


@torch.no_grad()
def generate(cfg: ModelCfg, model: DecoderLM, prompt_tokens, *,
             max_new_tokens=16, generator=None, temperature=1.0, top_k=64,
             top_p=1.0):
    """prompt_tokens: (B, S) -> (B, max_new_tokens) sampled ids (int32),
    on the model's device.  ``generator``: a ``torch.Generator`` on that
    device (None: one seeded with 0, as the reference's default key)."""
    check_family(cfg)
    dev = model.device
    prompt = torch.as_tensor(prompt_tokens, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    s = prompt.shape[1]

    logits, cache = api.prefill(cfg, model, {"tokens": prompt})
    # prefill emits an S-long cache; extend to max_len for decode writes
    cache = {kk: F.pad(vv, (0, 0, 0, 0, 0, max_new_tokens))
             for kk, vv in cache.items()}
    last = logits[:, -1]
    toks = []
    for i in range(max_new_tokens):
        tok = sample(last, generator, temperature=temperature, top_k=top_k,
                     top_p=top_p)
        lg, cache = api.decode_step(cfg, model, tok[:, None], cache, s + i)
        last = lg[:, 0]
        toks.append(tok)
    return torch.stack(toks, dim=1)
