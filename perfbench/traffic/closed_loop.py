"""Closed loop: one client feeds ``batch`` requests a call into one session
and feeds the next batch as soon as the call returns.

Mix keys: ``ops`` (op -> weight; each op gets exactly its share, in a
seeded order), ``dataset`` (a §V dataset of :mod:`.datasets`), ``length``
(keys a request), ``batch`` (requests a ``feed``), ``pool`` (base arrays).

Every request is new: the run draws ``pool`` base arrays from the seed
and each request is one of them rotated by an offset, the (base, offset)
pairs taken without repetition in a seeded order.  A rotation keeps the
dataset's distribution and changes the payload's bytes, so the engine's
result cache never serves a request, and it keeps the multiset of keys, so
the reference's column reads of a base hold for each of its rotations.
"""

from __future__ import annotations

import numpy as np

from .datasets import dataset
from .records import Req, keep, responses

WARM_BASES = 2          # base arrays of the warm pass, drawn apart


def _ops_sequence(ops: dict, count: int, block: int, rng) -> np.ndarray:
    """``count`` op names, each block of ``block`` holding every op in its
    exact share, in a seeded order."""
    names = sorted(ops)
    cycle = np.repeat(np.arange(len(names)),
                      [int(ops[k]) for k in names])
    if block % cycle.size:
        raise ValueError(f"batch {block} is no multiple of the op shares "
                         f"{dict(ops)}")
    rows = -(-count // block)
    seq = rng.permuted(np.tile(np.resize(cycle, block), (rows, 1)), axis=1)
    return np.asarray(names, dtype=object)[seq.ravel()[:count]]


def prepare(mix: dict, config: dict, seed: int, seconds: float) -> dict:
    """The run's request pool from ``seed``; nothing runs yet."""
    rng = np.random.default_rng([int(seed), 1])
    n, pool = int(mix["length"]), int(mix["pool"])
    w = int(config["w"])
    bases = np.stack([dataset(mix["dataset"], rng, n, w) for _ in range(pool)])
    warm = np.stack([dataset(mix["dataset"], rng, n, w)
                     for _ in range(WARM_BASES)])
    total = pool * n
    return {
        "n": n,
        "batch": int(mix["batch"]),
        "doubled": np.concatenate([bases, bases], axis=1),
        "warm": np.concatenate([warm, warm], axis=1),
        "pairs": rng.permutation(total),
        "ops": _ops_sequence(mix["ops"], total, int(mix["batch"]), rng),
        "warm_ops": _ops_sequence(mix["ops"], 2 * int(mix["batch"]),
                                  int(mix["batch"]), rng),
    }


def _payload(plan: dict, i: int) -> np.ndarray:
    base, off = divmod(int(plan["pairs"][i]), plan["n"])
    return plan["doubled"][base, off:off + plan["n"]]


def warm(plan: dict, engine, hooks) -> None:
    """Build every launcher the window uses, then feed two batches of
    payloads the window never sends through a session of their own."""
    from repro_torch.sortserve import SortRequest
    tile_rows = engine.config.tile_rows
    for op in sorted(set(plan["warm_ops"])):
        for be in engine.backends:
            if op in be.ops:
                be.warm(tile_rows, plan["n"], op, None)
    session = engine.begin()
    n = plan["n"]
    reqs = [SortRequest(op=op, payload=plan["warm"][i % WARM_BASES,
                                                    i:i + n])
            for i, op in enumerate(plan["warm_ops"])]
    half = len(reqs) // 2
    session.feed(reqs[:half])
    session.feed(reqs[half:])
    session.drain()
    hooks.synchronize()


def drive(plan: dict, engine, seconds: float, hooks) -> dict:
    """The measured window.  A response's time is the return of the
    ``feed`` call that delivered it."""
    from repro_torch.sortserve import SortRequest
    clock = hooks.clock
    session = engine.begin()
    batch = plan["batch"]
    limit = len(plan["pairs"])
    ops = plan["ops"]
    rids, t_submit, t_done, kept = [], [], [], []
    index: dict[int, int] = {}            # request id -> index, in flight
    error = None

    def take(got, t):
        for resp in got:
            i = index.pop(resp.request_id)
            kept[i] = keep(resp)
            t_done[i] = t

    hooks.opened()
    t0 = clock()
    end = t0 + seconds
    client = 0.0
    t = t0
    try:
        with hooks.span("window"):
            while clock() < end:
                first = len(rids)
                if first + batch > limit:
                    raise RuntimeError(f"request pool of {limit} exhausted")
                fed = [SortRequest(op=ops[i], payload=_payload(plan, i))
                       for i in range(first, first + batch)]
                for i, req in enumerate(fed, first):
                    index[req.request_id] = i
                    rids.append(req.request_id)
                kept += [None] * batch
                t_done += [float("nan")] * batch
                ts = clock()
                client += ts - t
                t_submit += [ts] * batch
                with hooks.span("feed"):
                    got = session.feed(fed)
                t = clock()
                take(got, t)
    except Exception as exc:                 # judged below, not raised
        error = exc
    t_loop = clock()
    hooks.closed()
    if error is None:
        try:
            got = session.drain()
            take(got, clock())
        except Exception as exc:
            error = exc
    n = plan["n"]
    requests = [Req(ops[i], _payload(plan, i), None, n, rid)
                for i, rid in enumerate(rids)]
    return {
        "requests": requests,
        "cr_keys": [int(plan["pairs"][i]) // n for i in range(len(rids))],
        "t_due": np.asarray(t_submit),
        "t_submit": np.asarray(t_submit),
        "t_done": np.asarray(t_done),
        "responses": responses(kept),
        "errors": [None] * len(rids),
        "t0": t0,
        "t_end": end,
        "t_loop": t_loop,
        "client_s": client,
        "error": error,
    }
