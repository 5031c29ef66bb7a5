"""99th percentile of how late the harness's generator submitted each
request after its due time (the front door's intake, as a client sees it)."""

from perfbench.metrics._lib import percentile


def read(ctx):
    w = ctx.window
    late = percentile(w["t_submit"] - w["t_due"], 99)
    return None if late is None else late * 1e3
