"""Host milliseconds a tile in the scheduler's event loop: the self time
of the engine's ``sortserve.schedule`` stage (``ContinuousScheduler.feed``
and ``pump``, less the execute and scatter stages inside it), over the
window's tiles."""

from perfbench.metrics._stages import ms_per_tile


def read(ctx):
    return ms_per_tile(ctx, ("sortserve.schedule",))
