"""Requests a tile over the tile's rows, in percent (batcher counters)."""


def read(ctx):
    tiles = ctx.batcher_delta("tiles")
    if tiles <= 0:
        return None
    return 100.0 * ctx.batcher_delta("requests") / (
        tiles * ctx.config["tile_rows"])
