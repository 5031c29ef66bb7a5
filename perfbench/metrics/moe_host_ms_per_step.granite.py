"""Host milliseconds of a decode step's MoE layers: the self seconds of
the stages ``moe.decode.route``, ``.dispatch``, ``.experts`` and
``.combine`` over the window's decode steps."""

from perfbench.metrics._stages import stage_s

PARTS = ("route", "dispatch", "experts", "combine")


def read(ctx):
    seconds = stage_s(ctx, [f"moe.decode.{p}" for p in PARTS])
    steps = ctx.delta("stages", "generate.decode", "n")
    return seconds / steps * 1e3 if seconds is not None and steps else None
