"""Share of the roofline of the radix top-k kernel
(``radix_threshold.cu``) in the model path: the routers' and the
sampler's launches, their rows' bytes at the card's HBM bandwidth
(``_roofline_moe.radix_least_s``) over the traced time of
``radix_narrow_kernel`` and ``radix_threshold_kernel``."""

from perfbench.metrics._roofline import share_pct
from perfbench.metrics._roofline_moe import radix_least_s


def read(ctx):
    least = radix_least_s(ctx) if ctx.trace is not None else None
    if least is None:
        return None
    return share_pct(least, ctx.kernel_s("radix_threshold_kernel",
                                         "radix_narrow_kernel"))
