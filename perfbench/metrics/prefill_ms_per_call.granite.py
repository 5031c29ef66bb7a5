"""Host milliseconds of a call's prefill: stage ``generate.prefill``'s
seconds (spans enclosed included) over its count in the window."""

from perfbench.metrics._stages import stage_s


def read(ctx):
    seconds = stage_s(ctx, ["generate.prefill"], "s")
    calls = ctx.delta("stages", "generate.prefill", "n")
    return seconds / calls * 1e3 if seconds is not None and calls else None
