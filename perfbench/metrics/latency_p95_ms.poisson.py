"""95th percentile, over every request due in the window, of response
time minus due time; a request that failed or never came counts as beyond
any limit (no number when that reaches the percentile)."""

import numpy as np


def read(ctx):
    w = ctx.window
    lat = w["t_done"] - w["t_due"]
    failed = np.array([r is None for r in w["responses"]], bool)
    lat = np.sort(np.where(failed | ~np.isfinite(lat), np.inf, lat))
    if lat.size == 0:
        return None
    # numpy's linear rule on the sorted values, with no arithmetic on inf
    at = 0.95 * (lat.size - 1)
    lo, hi = lat[int(np.floor(at))], lat[int(np.ceil(at))]
    if not np.isfinite(hi):
        return None
    return float(lo + (hi - lo) * (at - np.floor(at))) * 1e3
