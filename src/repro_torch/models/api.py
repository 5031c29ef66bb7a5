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
:func:`input_specs`, :func:`cache_specs` and :func:`cache_kinds` give
the reference's ``ShapeDtypeStruct`` specs as tensors on the ``meta``
device (shapes and dtypes, no storage), for the dry-run.
"""

from __future__ import annotations

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelCfg, ShapeCell
from . import blocks as B
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


# ------------------------------------------------------------ input specs

def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelCfg, cell: ShapeCell):
    """Batch dict of ``meta`` tensors for (train|prefill) steps."""
    b, s = cell.global_batch, cell.seq_len
    batch = {}
    if cfg.family == "encdec":
        batch["frames"] = _sds((b, cfg.enc_ctx, cfg.d_model), torch.float32)
        batch["tokens"] = _sds((b, s), torch.int32)
    elif cfg.family == "vlm":
        p = cfg.vision_patches
        batch["tokens"] = _sds((b, s - p), torch.int32)
        batch["patches"] = _sds((b, p, cfg.d_model), torch.float32)
        batch["positions3"] = _sds((b, s, 3), torch.int32)
    else:
        batch["tokens"] = _sds((b, s), torch.int32)
    return batch


def cache_specs(cfg: ModelCfg, batch: int, max_len: int, quant: bool = False):
    """``meta`` tensors of the decode state (KV cache of ``max_len``).

    ``quant=True`` (transformer family): int8 cache + per-(slot, head) fp32
    scales — the kv8 serving variant; its zeros made real are a kv8 cache
    for :func:`decode_step`."""
    dt = B.dtype_of(cfg)
    L = cfg.n_layers
    kv = (L, batch, max_len, cfg.n_kv, cfg.head_dim)
    if quant and cfg.family in ("dense", "moe", "vlm"):
        return {
            "k": _sds(kv, torch.int8),
            "v": _sds(kv, torch.int8),
            "k_scale": _sds(kv[:4], torch.float32),
            "v_scale": _sds(kv[:4], torch.float32),
        }
    if cfg.family == "ssm":
        return {
            "wkv": _sds((L, batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                        torch.float32),
            "x_tm": _sds((L, batch, cfg.d_model), dt),
            "x_cm": _sds((L, batch, cfg.d_model), dt),
        }
    if cfg.family == "hybrid":
        di = cfg.ssm.expand * cfg.d_model
        return {
            "k": _sds(kv, dt),
            "v": _sds(kv, dt),
            "conv": _sds((L, batch, cfg.ssm.d_conv - 1, di), dt),
            "ssm": _sds((L, batch, di, cfg.ssm.state_dim), torch.float32),
        }
    if cfg.family == "encdec":
        xkv = (L, batch, cfg.enc_ctx, cfg.n_kv, cfg.head_dim)
        return {"k": _sds(kv, dt), "v": _sds(kv, dt),
                "xk": _sds(xkv, dt), "xv": _sds(xkv, dt)}
    return {"k": _sds(kv, dt), "v": _sds(kv, dt)}


def cache_kinds(cfg: ModelCfg, quant: bool = False):
    """Map cache leaf name -> sharding kind (see dist.sharding.cache_spec)."""
    if quant and cfg.family in ("dense", "moe", "vlm"):
        return {"k": "kv", "v": "kv", "k_scale": "kvscale", "v_scale": "kvscale"}
    if cfg.family == "ssm":
        return {"wkv": "wkv", "x_tm": "vec", "x_cm": "vec"}
    if cfg.family == "hybrid":
        return {"k": "kv", "v": "kv", "conv": "conv", "ssm": "ssm"}
    if cfg.family == "encdec":
        return {"k": "kv", "v": "kv", "xk": "xkv", "xv": "xkv"}
    return {"k": "kv", "v": "kv"}
