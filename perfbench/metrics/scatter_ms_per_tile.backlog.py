"""Host milliseconds a tile in scatter: the engine's ``sortserve.scatter``
stage (each request's decode and response, the cache insert, the
records), over the window's tiles."""

from perfbench.metrics._stages import ms_per_tile


def read(ctx):
    return ms_per_tile(ctx, ("sortserve.scatter",))
