"""Keys of every request answered inside the window, over its seconds."""

import numpy as np


def read(ctx):
    w = ctx.window
    got = np.array([r is not None for r in w["responses"]], bool)
    inside = got & (w["t_done"] <= w["t_end"])
    n = np.array([q.n for q in w["requests"]], np.int64)
    return float(n[inside].sum()) / ctx.seconds
