"""Host milliseconds of a colskip tile: the backend's ``run`` (copy in,
launch, copies out) from engine telemetry."""


def read(ctx):
    tiles = ctx.backend_tiles("colskip")
    return ctx.backend_wall("colskip") / tiles * 1e3 if tiles > 0 else None
