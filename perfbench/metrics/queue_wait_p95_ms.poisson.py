"""95th percentile of a request's wait from its feed to the start of its
tile's execution (the program's request tracer: ``t_exec0 - t_feed``)."""

from perfbench.metrics._lib import percentile

NEEDS = {"tracer"}


def read(ctx):
    if ctx.tracer is None:
        return None
    rids = {q.request_id for q in ctx.window["requests"]}
    waits = [c["tile"]["t_exec0"] - c["t_feed"] for c in ctx.tracer.chains
             if c["rid"] in rids and c["tile"] is not None
             and c["tile"].get("t_exec0") is not None]
    p95 = percentile(waits, 95)
    return None if p95 is None else p95 * 1e3
