"""Sentinel columns in the rows of real requests, in percent of their
columns (batcher counters)."""


def read(ctx):
    pad = ctx.batcher_delta("pad_cols")
    total = pad + ctx.batcher_delta("real_elems")
    return 100.0 * pad / total if total > 0 else None
