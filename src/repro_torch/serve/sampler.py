"""Sampling head built on the paper's selection engine.

The port of ``repro/serve/sampler.py``.  Top-k runs through
:func:`repro_torch.kernels.radix_topk.radix_topk` (the radix threshold
kernel on the card; vocab rows wider than its 16,384 columns take the
two-level bank path: one launch over the banks, one manager pass); top-p
is then applied *within* the k candidates.  ``jax.random.categorical``
becomes Gumbel-max on an explicit ``torch.Generator`` on the logits'
device: the arg max of ``log p - log E``, E exponential draws.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.radix_topk import radix_topk


def sample(logits, generator=None, *, temperature=1.0, top_k=64, top_p=1.0):
    """logits: (B, V) -> token ids (B,) int32.  ``generator`` lives on the
    logits' device (None: the device's default generator)."""
    b, v = logits.shape
    lg = logits.float() / max(float(temperature), 1e-6)
    k = min(top_k, v)
    vals, idx = radix_topk(lg, k, device=lg.device)          # descending
    lp = torch.log_softmax(vals, dim=-1)
    if top_p < 1.0:
        probs = lp.exp()
        cum = probs.cumsum(-1)
        # keep the smallest prefix with mass >= top_p (always keep argmax)
        keep = (cum - probs) < top_p
        lp = lp.masked_fill(~keep, float("-inf"))
    e = torch.empty_like(lp).exponential_(generator=generator)
    choice = (lp - e.log()).argmax(-1)
    return idx.gather(1, choice[:, None])[:, 0]


def greedy(logits):
    vals, idx = radix_topk(logits.float(), 1, device=logits.device)
    return idx[:, 0]
