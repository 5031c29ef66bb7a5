"""Seconds from the process's start to the window's: imports, the card,
the request pool, the engine and every launcher and shape of the cell."""


def read(ctx):
    return ctx.setup_s
