"""Share of the window the front door's collector thread spent in its
passes (the engine's ``frontdoor.collect`` stage: from the queue's return
to the next wait), over the window's host seconds."""

from perfbench.metrics._stages import stage_s


def read(ctx):
    busy = stage_s(ctx, ("frontdoor.collect",), key="s")
    loop = ctx.loop_s()
    if not busy or loop <= 0:
        return None
    return 100.0 * busy / loop
