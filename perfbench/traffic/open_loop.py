"""Open loop: independent users submit through the async front door on a
fixed schedule of Poisson arrivals, whatever the service's state.

Mix keys: ``rate_per_s`` (offered requests a second), ``ops`` (op ->
weight), ``dtypes`` (payload dtypes, equal shares), ``length`` (``min``,
``max``: keys a request, log-uniform), ``k_max`` (topk / kmin take k
uniform in 1 .. min(k_max, n)), ``max_batch`` and ``max_wait_ms`` (the
front door's), ``settle_s`` (how long past the window the harness waits
for the last responses).

The request stream is the launcher's mixed stream (a copy of
``repro_torch.launch.sortserve.make_workload``: ops, dtypes, log-uniform
lengths, k, payload draws) with the Poisson gaps of
``repro_torch.benchmarks.streaming_bench.poisson_trace``, drawn so that
every seed offers the same work in another order: the gaps, each op's
lengths and k are evenly spaced quantiles of their distributions, shuffled
by the seed; only the keys are fresh random draws.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from perfbench.reference.sortref import pow2_width

from .datasets import launcher_payload
from .records import Req, keep, responses


def _quantiles(count: int, rng) -> np.ndarray:
    """``count`` evenly spaced points of (0, 1) in a seeded order."""
    return (rng.permutation(count) + 0.5) / count


def _shares(names, count: int, rng) -> np.ndarray:
    """``count`` labels, each name in an equal share, in a seeded order."""
    names = list(names)
    return np.asarray(names, dtype=object)[
        rng.permutation(np.resize(np.arange(len(names)), count))]


def prepare(mix: dict, config: dict, seed: int, seconds: float) -> dict:
    """The window's whole schedule and payloads from ``seed``."""
    rng = np.random.default_rng([int(seed), 2])
    rate = float(mix["rate_per_s"])
    total = int(round(rate * seconds))
    gaps = -np.log1p(-_quantiles(total, rng)) / rate
    arrivals = np.cumsum(gaps) - gaps[0]
    ops = _shares(sorted(mix["ops"]), total, rng)
    lo, hi = int(mix["length"]["min"]), int(mix["length"]["max"])
    k_max = int(mix["k_max"])
    n = np.empty(total, np.int64)
    k = np.zeros(total, np.int64)
    for op in sorted(set(ops)):
        at = np.flatnonzero(ops == op)
        q = _quantiles(at.size, rng)
        n[at] = np.clip(np.exp(np.log(lo) + q * np.log(hi / lo)).astype(
            np.int64), lo, hi)
        if op in ("topk", "kmin"):
            cap = np.minimum(k_max, n[at])
            k[at] = 1 + (_quantiles(at.size, rng) * cap).astype(np.int64)
    dtypes = _shares(mix["dtypes"], total, rng)
    payloads = [None] * total
    for dt in sorted(set(dtypes)):
        at = np.flatnonzero(dtypes == dt)
        keys = launcher_payload(rng, int(n[at].sum()), dt)
        for i, part in zip(at, np.split(keys, np.cumsum(n[at])[:-1])):
            payloads[i] = part
    return {"gaps": gaps, "arrivals": arrivals, "ops": ops, "n": n, "k": k,
            "payloads": payloads, "mix": mix, "seed": int(seed),
            "min_bucket": int(config["min_bucket"])}


def warm(plan: dict, engine, hooks) -> None:
    """Build the launcher of every tile signature the window can form and
    run one tile of each, then serve a short burst through the front door
    the window uses.  Warm payloads are drawn apart from the window's."""
    from repro_torch.sortserve import AsyncSortServe, SortRequest
    rng = np.random.default_rng([plan["seed"], 3])
    mb = plan["min_bucket"]
    sigs = sorted({(op, pow2_width(n, mb), pow2_width(k, 1) if k else None)
                   for op, n, k in zip(plan["ops"], plan["n"], plan["k"])},
                  key=repr)
    tile_rows = engine.config.tile_rows
    warm_reqs = []
    for op, width, kp in sigs:
        for be in engine.backends:
            if op in be.ops:
                be.warm(tile_rows, width, op, kp)
        keys = launcher_payload(rng, width, "uint32")
        warm_reqs.append(SortRequest(op=op, payload=keys,
                                     k=min(kp, width) if kp else None))
    session = engine.begin()
    session.feed(warm_reqs, flush=True)
    session.drain()
    mix = plan["mix"]
    front = AsyncSortServe(engine, max_batch=int(mix["max_batch"]),
                           max_wait_ms=float(mix["max_wait_ms"]))
    burst = [SortRequest(op=r.op, payload=r.payload.copy()[::-1].copy(),
                         k=r.k) for r in warm_reqs]
    for fut in [front.submit(r) for r in burst]:
        fut.exception(timeout=60.0)
    plan["front"] = front
    hooks.synchronize()


def drive(plan: dict, engine, seconds: float, hooks) -> dict:
    """Submit each request at its due time; after the window, wait up to
    ``settle_s`` for every response.  A response's time is when its future
    resolved."""
    from repro_torch.sortserve import SortRequest
    clock = hooks.clock
    front = plan["front"]
    ops, ks, payloads = plan["ops"], plan["k"], plan["payloads"]
    total = len(ops)
    arrivals = plan["arrivals"]
    t_submit = np.full(total, np.nan)
    t_done = np.full(total, np.nan)
    kept: list = [None] * total
    errors: list = [None] * total
    rids = [0] * total
    lock = threading.Lock()
    state = {"left": total}
    all_done = threading.Event()

    def stamp(i):
        def done(fut):
            t_done[i] = clock()
            exc = fut.exception()
            if exc is None:
                kept[i] = keep(fut.result())
            else:
                errors[i] = repr(exc)
            with lock:
                state["left"] -= 1
                if state["left"] == 0:
                    all_done.set()
        return done

    hooks.opened()
    t0 = clock() + 1e-3
    with hooks.span("window"):
        for i in range(total):
            req = SortRequest(op=ops[i], payload=payloads[i],
                              k=int(ks[i]) if ks[i] else None)
            rids[i] = req.request_id
            wait = t0 + arrivals[i] - clock()
            if wait > 0:
                time.sleep(wait)
            t_submit[i] = clock()
            with hooks.span("submit"):
                fut = front.submit(req)
            fut.add_done_callback(stamp(i))
        settle = max(t0 + seconds, clock()) + float(plan["mix"]["settle_s"])
        all_done.wait(timeout=max(0.0, settle - clock()))
    t_loop = clock()
    hooks.closed()
    finished = all_done.is_set()
    if finished:
        front.close()
    for i in range(total):
        if kept[i] is None and errors[i] is None:
            errors[i] = "no response before the settle time"
    requests = [Req(ops[i], payloads[i], int(ks[i]) if ks[i] else None,
                    int(plan["n"][i]), rids[i]) for i in range(total)]
    return {
        "requests": requests,
        "cr_keys": [None] * total,
        "t_due": t0 + arrivals,
        "t_submit": t_submit,
        "t_done": t_done,
        "responses": responses(kept),
        "errors": errors,
        "t0": t0,
        "t_end": t0 + seconds,
        "t_loop": t_loop,
        "error": None if finished else RuntimeError(
            "requests left unanswered at the settle time"),
    }
