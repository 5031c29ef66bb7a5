"""Host milliseconds a tile in bucketing: the self time of the engine's
``sortserve.bucket`` stage (validation, the cache key, encoding,
``Batcher.add``) and ``sortserve.emit`` stage (padded tile assembly), over
the window's tiles."""

from perfbench.metrics._stages import ms_per_tile


def read(ctx):
    return ms_per_tile(ctx, ("sortserve.bucket", "sortserve.emit"))
