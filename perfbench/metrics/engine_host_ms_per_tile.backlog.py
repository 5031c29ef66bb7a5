"""Host milliseconds a tile in the engine outside the backends' ``run``:
the window less the backends' summed wall time (engine telemetry) and
less the harness's own client time, over the tiles run."""


def read(ctx):
    pb = ctx.marks["close"]["telemetry"]["per_backend"]
    tiles = sum(ctx.backend_tiles(b) for b in pb)
    wall = sum(ctx.backend_wall(b) for b in pb)
    if tiles <= 0:
        return None
    client = ctx.window.get("client_s", 0.0)
    return (ctx.loop_s() - client - wall) / tiles * 1e3
