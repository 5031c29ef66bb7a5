"""Share of the roofline of the expert GEMMs (``torch._grouped_mm`` on
the card, found in the trace by kernel name): their least time for the
window's MoE passes (``_roofline_moe.expert_gemm_least_s``) over their
traced device time."""

from perfbench.metrics._roofline import share_pct
from perfbench.metrics._roofline_moe import expert_gemm_least_s

KERNELS = ("GroupProblemShape",)


def read(ctx):
    least = expert_gemm_least_s(ctx) if ctx.trace is not None else None
    if least is None:
        return None
    return share_pct(least, ctx.kernel_s(*KERNELS))
