"""The plain reference of IBM Granite 3.0 MoE (HF ``GraniteMoeForCausalLM``)
and the seeded weights that the benchmark's program and this reference
share.

Imports nothing of the program: plain ``torch`` in float32, no kernel, no
cache, no batching beyond stacking whole sequences; TF32 off for its
matrix products (:func:`forward`).  ``hf`` is the configuration under HF's
key names (``perfbench/configs/granite-3.0-3b-a800m.json``).  The forward
follows HF's ``modeling_granitemoe.py``:

  * ``x = embed[ids] * embedding_multiplier``;
  * each layer: ``x += attn(rms(x)) * residual_multiplier``, then ``x +=
    moe(rms(x)) * residual_multiplier``; RMSNorm is ``weight * x_hat``
    with ``rms_norm_eps``;
  * attention: RoPE (rotate-half, ``rope_theta``), grouped KV heads
    (query head h reads KV head h // (H / KV)), scores x
    ``attention_multiplier``, causal softmax;
  * MoE: router logits ``x @ router.T``, top-k, softmax over the k;
    expert e: ``w_out[e] @ (silu(g) * u)`` with ``(g, u)`` the halves of
    ``w_in[e] @ x`` (gate first); every routed entry computed (dropless);
  * logits ``rms(x) @ embed.T / logits_scaling`` (tied embeddings).

Departures from HF: everything in float32 (HF runs the checkpoint's
bfloat16); the top-k gates stay float32 (HF casts them to the hidden
dtype); an expert's outputs are summed per token by ``index_add_`` in
float32; no attention dropout, cache or padding mask (none applies to
whole prompts); logits only of the positions asked for.

``tests/_granite_ref.py`` is a copy of this file for the CPU tests, which
hold the two equal.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


# ------------------------------------------------------------------ weights

def tensor_specs(hf: dict) -> list:
    """``(name, shape, fan_in)`` of every parameter of the model, in HF's
    names and ``(out, in)`` layouts, in a fixed order; ``fan_in`` None
    marks an RMSNorm weight."""
    d, L = hf["hidden_size"], hf["num_hidden_layers"]
    h, kv = hf["num_attention_heads"], hf["num_key_value_heads"]
    dh = d // h
    e, de, v = (hf["num_local_experts"], hf["intermediate_size"],
                hf["vocab_size"])
    specs = [("model.embed_tokens.weight", (v, d), d)]
    for i in range(L):
        p = f"model.layers.{i}."
        specs += [
            (p + "input_layernorm.weight", (d,), None),
            (p + "self_attn.q_proj.weight", (h * dh, d), d),
            (p + "self_attn.k_proj.weight", (kv * dh, d), d),
            (p + "self_attn.v_proj.weight", (kv * dh, d), d),
            (p + "self_attn.o_proj.weight", (d, h * dh), h * dh),
            (p + "post_attention_layernorm.weight", (d,), None),
            (p + "block_sparse_moe.router.layer.weight", (e, d), d),
            (p + "block_sparse_moe.input_linear.weight", (e, 2 * de, d), d),
            (p + "block_sparse_moe.output_linear.weight", (e, d, de), de),
        ]
    specs.append(("model.norm.weight", (d,), None))
    return specs


def draw(seed: int, index: int, shape, fan_in, device) -> torch.Tensor:
    """Tensor ``index`` of :func:`tensor_specs` for ``seed``, float32:
    N(0, 1 / fan_in) for a matrix (the embedding's fan-in is the hidden
    size it feeds as the tied head), 1 + 0.1 N(0, 1) for an RMSNorm
    weight, so that a norm left out shows.  Each tensor has a generator
    of its own, seeded from ``(seed, index)``, so any one can be drawn
    alone; the numbers depend on the device's generator."""
    word = np.random.SeedSequence([int(seed) % 2**64, index]) \
        .generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(word) % 2**63)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    if fan_in is None:
        return x.mul_(0.1).add_(1.0)
    return x.mul_(1.0 / math.sqrt(fan_in))


def weights(hf: dict, seed: int, device):
    """Every ``(name, tensor)`` of the model for ``seed``, drawn one at a
    time in :func:`tensor_specs`' order."""
    for i, (name, shape, fan_in) in enumerate(tensor_specs(hf)):
        yield name, draw(seed, i, shape, fan_in, device)


class Weights:
    """Tensors of :func:`tensor_specs` by name, drawn when first asked for
    and kept until :meth:`drop`."""

    def __init__(self, hf: dict, seed: int, device):
        self.seed, self.device = seed, device
        self.specs = {name: (i, shape, fan_in) for i, (name, shape, fan_in)
                      in enumerate(tensor_specs(hf))}
        self.held: dict = {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self.held:
            self.held[name] = draw(self.seed, *self.specs[name], self.device)
        return self.held[name]

    def drop(self, prefix: str) -> None:
        for name in [n for n in self.held if n.startswith(prefix)]:
            del self.held[name]


# ------------------------------------------------------------------ forward

@contextlib.contextmanager
def no_tf32():
    """float32 matrix products in float32, not TF32, for the block."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def rms_norm(x, weight, eps):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def _attention(hf, w, p, x, cos, sin):
    n, s, d = x.shape
    h, kv = hf["num_attention_heads"], hf["num_key_value_heads"]
    dh = d // h
    q = (x @ w[p + "self_attn.q_proj.weight"].T).view(n, s, h, dh)
    k = (x @ w[p + "self_attn.k_proj.weight"].T).view(n, s, kv, dh)
    v = (x @ w[p + "self_attn.v_proj.weight"].T).view(n, s, kv, dh)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    q = q * cos + _rotate_half(q) * sin
    k = k * cos + _rotate_half(k) * sin
    k = k.repeat_interleave(h // kv, dim=1)
    v = v.repeat_interleave(h // kv, dim=1)
    scores = (q @ k.transpose(-1, -2)) * hf["attention_multiplier"]
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = torch.softmax(scores, dim=-1) @ v
    out = out.transpose(1, 2).reshape(n, s, h * dh)
    return out @ w[p + "self_attn.o_proj.weight"].T


def _moe(hf, w, p, x):
    n, s, d = x.shape
    xf = x.reshape(n * s, d)
    logits = xf @ w[p + "block_sparse_moe.router.layer.weight"].T
    top, idx = logits.topk(hf["num_experts_per_tok"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    w_in = w[p + "block_sparse_moe.input_linear.weight"]
    w_out = w[p + "block_sparse_moe.output_linear.weight"]
    out = torch.zeros_like(xf)
    for e in range(hf["num_local_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        g, u = (xf[tok] @ w_in[e].T).chunk(2, dim=-1)
        y = (F.silu(g) * u) @ w_out[e].T
        out.index_add_(0, tok, y * gates[tok, slot, None])
    return out.view(n, s, d)


@torch.no_grad()
def forward(hf: dict, w, tokens, first: int = 0) -> torch.Tensor:
    """Logits (N, S - first, vocab_size) float32 of ``tokens`` (N, S), for
    positions ``first`` to S - 1; ``w`` maps HF names to float32 tensors
    (a :class:`Weights`, from which each layer's are dropped once used)."""
    eps, rm = hf["rms_norm_eps"], hf["residual_multiplier"]
    n, s = tokens.shape
    d = hf["hidden_size"]
    dh = d // hf["num_attention_heads"]
    with no_tf32():
        x = w["model.embed_tokens.weight"][tokens] \
            * hf["embedding_multiplier"]
        dev = x.device
        inv = 1.0 / (hf["rope_theta"] ** (
            torch.arange(0, dh, 2, device=dev, dtype=torch.float32) / dh))
        ang = torch.arange(s, device=dev, dtype=torch.float32)[:, None] * inv
        emb = torch.cat((ang, ang), dim=-1)
        cos, sin = emb.cos(), emb.sin()
        for i in range(hf["num_hidden_layers"]):
            p = f"model.layers.{i}."
            h = rms_norm(x, w[p + "input_layernorm.weight"], eps)
            x = x + _attention(hf, w, p, h, cos, sin) * rm
            h = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
            x = x + _moe(hf, w, p, h) * rm
            if hasattr(w, "drop"):
                w.drop(p)
        x = rms_norm(x[:, first:], w["model.norm.weight"], eps)
        return (x @ w["model.embed_tokens.weight"].T) \
            / hf["logits_scaling"]
