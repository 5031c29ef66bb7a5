"""Unified model API, the port of ``repro/models/api.py``: every arch
exposes the same entry points.

    init(cfg, seed=0, device="cuda")                 -> model
    loss(cfg, model, batch, act_specs=)              -> (CE + aux, metrics)
    prefill(cfg, model, batch, act_specs=)           -> (logits, cache)
    decode_step(cfg, model, tok, cache, n, act_specs=) -> (logits, cache)
    init_cache(cfg, batch, max_len, model=, frames=, device=) -> cache

The family picks the module, as the reference's ``_family_mod`` does:
``ssm`` is RWKV-6, ``hybrid`` Hymba, ``encdec`` Whisper, and the dense,
MoE and VLM families the generic decoder.  Each entry point runs on the
model's device: ``"cuda"`` unless the caller built the model with
``device="cpu"``.  ``loss`` is the training objective; autograd records
it once the model is :meth:`~.transformer.LM.trainable`.  ``act_specs``
(:func:`repro_torch.dist.sharding.act_specs`) carries a mesh to the MoE
layers, which then run expert-parallel over its ``model`` axis; the
reference's ``shard_act`` constraints have no counterpart (each rank
already holds its own data shard), so the other families take no part.
The shape specs come with the tooling (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelCfg
from . import hymba, rwkv6, transformer, whisper

_MODULES = {"ssm": rwkv6, "hybrid": hymba, "encdec": whisper}
_MODELS = {"ssm": rwkv6.RWKV6LM, "hybrid": hymba.HymbaLM,
           "encdec": whisper.WhisperModel}


def _family_mod(cfg: ModelCfg):
    return _MODULES.get(cfg.family, transformer)


def model_class(cfg: ModelCfg):
    """The ``nn.Module`` that holds the arch's weights."""
    return _MODELS.get(cfg.family, transformer.DecoderLM)


def _mesh_kw(cfg: ModelCfg, act_specs) -> dict:
    """``act_specs`` for the generic decoder (its MoE layers read the
    mesh); nothing for the families without a layer that communicates."""
    return {"act_specs": act_specs} if _family_mod(cfg) is transformer \
        else {}


def init(cfg: ModelCfg, *, seed: int = 0, device="cuda"):
    """A model with weights drawn from a ``torch.Generator`` seeded with
    ``seed``, on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return model_class(cfg)(cfg, device=dev, generator=gen)


def _ce(logits, labels):
    """Mean next-token cross-entropy in float32: logsumexp minus the
    label's logit."""
    logits = logits.float()
    correct = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, -1) - correct).mean()


def loss(cfg: ModelCfg, model, batch, *, act_specs=None):
    """Next-token CE (+ 0.01 x the MoE router's aux loss) -> (total,
    {"ce": ce}).  Labels are the tokens shifted left; a VLM scores only
    its text region (the patches come first).  Every layer's activations
    are recomputed in backward, as the reference's ``jax.checkpoint``
    bodies are."""
    logits, aux = _family_mod(cfg).forward(
        cfg, model, batch, **_mesh_kw(cfg, act_specs))[:2]
    tokens = torch.as_tensor(batch["tokens"], device=model.device)
    if cfg.family == "vlm":
        logits = logits[:, cfg.vision_patches:]
    ce = _ce(logits[:, :-1], tokens[:, 1:])
    total = ce + 0.01 * aux if cfg.moe is not None else ce
    return total, {"ce": ce}


@torch.no_grad()
def prefill(cfg: ModelCfg, model, batch, *, act_specs=None):
    """The prompt -> (last logits (B, 1, V), decode state), each family as
    the reference: ``ssm`` returns its state after the prompt; ``encdec``
    and ``hybrid`` return forward's last logits with an *empty* state
    (the cross K/V beside a zero self-attention cache of prompt length;
    a zero hybrid state), and Whisper's logits carry no vocab mask."""
    if cfg.family == "ssm":
        logits, state = rwkv6.forward(cfg, model, batch)
        return logits[:, -1:], state
    if cfg.family == "encdec":
        cache = whisper.init_cache(cfg, model, batch["frames"],
                                   max_len=batch["tokens"].shape[1])
        logits, _ = whisper.forward(cfg, model, batch)
        return logits[:, -1:], cache
    if cfg.family == "hybrid":
        logits, _ = hymba.forward(cfg, model, batch)
        b, s = batch["tokens"].shape
        return logits[:, -1:], hymba.init_state(cfg, b, s, model.device)
    return transformer.prefill(cfg, model, batch, act_specs=act_specs)


@torch.no_grad()
def decode_step(cfg: ModelCfg, model, token, cache, cache_len, *,
                act_specs=None):
    return _family_mod(cfg).decode_step(cfg, model, token, cache,
                                          cache_len, **_mesh_kw(cfg, act_specs))


@torch.no_grad()
def init_cache(cfg: ModelCfg, batch: int, max_len: int, *, model=None,
               frames=None, device="cuda"):
    """The empty decode state of ``batch`` rows and ``max_len`` slots.
    ``encdec`` needs the model and the frames (its cross K/V come from
    the encoder) and builds on the model's device."""
    if cfg.family == "encdec":
        if model is None or frames is None:
            raise ValueError("encdec: init_cache needs the model and the "
                             "frames")
        return whisper.init_cache(cfg, model, frames, max_len)
    if cfg.family == "ssm":
        return rwkv6.init_state(cfg, batch, device)
    if cfg.family == "hybrid":
        return hymba.init_state(cfg, batch, max_len, device)
    return transformer.init_cache(cfg, batch, max_len, device=device)
