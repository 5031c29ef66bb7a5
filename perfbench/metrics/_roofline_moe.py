"""The work of the model path's kernels, for the granite cell's rooflines.

Peaks of one NVIDIA H100 SXM at its 700 W limit (data sheet): 989.4
TFLOP/s of dense bf16 on the tensor cores, HBM3 at 3.35 TB/s
(:data:`._roofline.HBM_BYTES_PER_S`).  The counts come from the model's
counters (``telemetry()["counters"]``) over the window, for each MoE span
(``moe``: the prefill's passes, ``moe.decode``: the decode steps'); each
span's passes have one shape, so the least time of a span's passes is
the larger of their operations and their bytes at the peaks.
"""

from __future__ import annotations

from ._roofline import HBM_BYTES_PER_S

BF16_FLOPS_PER_S = 989.4e12
BF16_BYTES = 2
MOE_SPANS = ("moe", "moe.decode")


def expert_gemm_least_s(ctx) -> float | None:
    """Least time of the expert GEMMs of the window's MoE passes: 3 x 2 x
    d x d_expert FLOP an entry (gate, up, down); bytes: each hit expert's
    three matrices once a pass, and each entry's row in and out (d values
    each).  None where the program counts no pass."""
    d, de = ctx.config["hidden_size"], ctx.config["intermediate_size"]
    least = 0.0
    for span in MOE_SPANS:
        entries = ctx.delta("counters", f"{span}.entries")
        if entries <= 0:
            continue
        hit = ctx.delta("counters", f"{span}.experts_hit")
        flops = 6.0 * d * de * entries
        nbytes = BF16_BYTES * (3.0 * d * de * hit + 2.0 * d * entries)
        least += max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return least or None


def radix_bytes(rows: float, width: int, k: int) -> float:
    """Bytes of a float32 top-k launch over ``rows`` rows of ``width``: the
    rows read once, k values and k positions a row written once."""
    return 4.0 * rows * width + 8.0 * rows * k


def radix_least_s(ctx) -> float | None:
    """Least time of the window's radix launches: the routers' (T rows of
    E logits a pass, k = experts per token) and the sampler's (a row of
    the padded vocabulary a generated token, k = the sampling top_k)."""
    c = ctx.config
    e, k = c["num_local_experts"], c["num_experts_per_tok"]
    nbytes = sum(radix_bytes(ctx.delta("counters", f"{span}.entries") / k,
                             e, k) for span in MOE_SPANS)
    padded = -(-c["vocab_size"] // 256) * 256
    nbytes += radix_bytes(ctx.delta("counters", "generate.tokens"), padded,
                          c["sampling"]["top_k"])
    return nbytes / HBM_BYTES_PER_S if nbytes > 0 else None
