"""Host milliseconds of a colskip_mesh tile: the backend's ``run`` (copy in,
launch, copies out) from engine telemetry."""


def read(ctx):
    tiles = ctx.backend_tiles("colskip_mesh")
    if tiles <= 0:
        return None
    return ctx.backend_wall("colskip_mesh") / tiles * 1e3
