"""95th percentile of a request's wait in the front door's queue, from
its submit to the collector taking it off the queue (the program's
request tracer: ``t_ingest - t_feed``)."""

from perfbench.metrics._lib import percentile

NEEDS = {"tracer"}


def read(ctx):
    if ctx.tracer is None:
        return None
    rids = {q.request_id for q in ctx.window["requests"]}
    waits = [c["t_ingest"] - c["t_feed"] for c in ctx.tracer.chains
             if c["rid"] in rids and c.get("t_ingest") is not None]
    p95 = percentile(waits, 95)
    return None if p95 is None else p95 * 1e3
