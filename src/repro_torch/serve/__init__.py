"""Serving of the port: the radix sampler and the batched generation
engine (the twins of ``repro/serve``)."""

from .sampler import greedy, sample
from .engine import generate

__all__ = ["sample", "greedy", "generate"]
