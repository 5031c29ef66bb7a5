"""The most-loaded expert's entries over the mean expert's, x 100, over
the window's MoE passes: the counters' summed maxima x experts over the
entries (100 is an even load)."""

from perfbench.metrics._roofline_moe import MOE_SPANS


def read(ctx):
    entries = sum(ctx.delta("counters", f"{s}.entries") for s in MOE_SPANS)
    top = sum(ctx.delta("counters", f"{s}.max_load") for s in MOE_SPANS)
    if entries <= 0:
        return None
    return 100.0 * top * ctx.config["num_local_experts"] / entries
