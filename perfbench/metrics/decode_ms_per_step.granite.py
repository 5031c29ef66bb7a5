"""Host milliseconds of a decode step: stage ``generate.decode``'s
seconds (spans enclosed included) over its count in the window."""

from perfbench.metrics._stages import stage_s


def read(ctx):
    seconds = stage_s(ctx, ["generate.decode"], "s")
    steps = ctx.delta("stages", "generate.decode", "n")
    return seconds / steps * 1e3 if seconds is not None and steps else None
