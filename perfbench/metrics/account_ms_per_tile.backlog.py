"""Host milliseconds a tile in the engine's accounting around a backend's
``run``: the self time of the ``sortserve.execute`` stage (routing,
``policy.observe``, calibration, the windowed metrics and the counters),
over the window's tiles."""

from perfbench.metrics._stages import ms_per_tile


def read(ctx):
    return ms_per_tile(ctx, ("sortserve.execute",))
