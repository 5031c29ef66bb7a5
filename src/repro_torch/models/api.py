"""Unified model API, the port of ``repro/models/api.py`` for the dense and
MoE families:

    init(cfg, seed=0, device="cuda")            -> DecoderLM
    prefill(cfg, model, batch)                  -> (logits, cache)
    decode_step(cfg, model, tok, cache, n)      -> (logits, cache)
    init_cache(cfg, batch, max_len, device=...) -> cache

Each runs on the model's device: ``"cuda"`` unless the caller built the
model with ``device="cpu"``.  The other families (ssm, hybrid, encdec,
vlm) raise ``NotImplementedError`` (ROADMAP Queue 1 item 2); ``loss`` and
the shape specs come with training and the tooling (items 3 and 6).
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelCfg
from . import transformer
from .transformer import DecoderLM, check_family


def init(cfg: ModelCfg, *, seed: int = 0, device="cuda") -> DecoderLM:
    """A model with weights drawn from a ``torch.Generator`` seeded with
    ``seed``, on ``device``."""
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return DecoderLM(cfg, device=dev, generator=gen)


@torch.no_grad()
def prefill(cfg: ModelCfg, model: DecoderLM, batch):
    check_family(cfg)
    return transformer.prefill(cfg, model, batch)


@torch.no_grad()
def decode_step(cfg: ModelCfg, model: DecoderLM, token, cache, cache_len):
    check_family(cfg)
    return transformer.decode_step(cfg, model, token, cache, cache_len)


def init_cache(cfg: ModelCfg, batch: int, max_len: int, *, device="cuda"):
    check_family(cfg)
    return transformer.init_cache(cfg, batch, max_len, device=device)
