"""The comparison that decides ``correct``: every served response against
the plain reference of :mod:`.sortref`.

For every request offered in a run: a response came (``missing``), from
the backend the configuration states for its op (``backend``), with the
reference's values (``values``) and positions (``indices``).  Column
reads and cycles (``reads``, ``cycles``) are held against the reference
for every row whose keys' multiset the run names (the closed loop's
rotations of a base array: the machine's counts depend on the multiset
only) and every radix row, and for a seeded sample of the other machine
rows.  Every count has the limit 0.

The reference's orders come from a stable ``torch.sort`` on 64-bit keys,
in blocks of rows, on the device it is given: plain PyTorch, which the
program under test does not use for these ops.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from .sortref import (colskip_reads, encode, padded_row, plane_reads,
                      pow2_width)

MACHINE = ("colskip", "colskip_mesh")
BLOCK_ROWS = 8192
LIMITS = {"missing": 0, "backend": 0, "values": 0, "indices": 0,
          "reads": 0, "cycles": 0}


def _same(got, want) -> bool:
    got = None if got is None else np.asarray(got)
    return (got is not None and got.shape == want.shape
            and got.dtype == want.dtype
            and np.array_equal(got.view(np.uint8), want.view(np.uint8)))


def _orders(rows: np.ndarray, descending: bool, device) -> np.ndarray:
    """Stable order of each row of sortable keys (ascending, or
    descending with ties by ascending position)."""
    keys = torch.from_numpy(rows.astype(np.int64)).to(device)
    if descending:
        keys = 0xFFFFFFFF - keys
    return torch.sort(keys, dim=1, stable=True).indices.cpu().numpy()


def _check_answers(requests, responses, device) -> tuple[int, int]:
    """``(values wrong, indices wrong)`` over every request that got a
    response."""
    groups = defaultdict(list)
    for i, (req, resp) in enumerate(zip(requests, responses)):
        if resp is not None:
            groups[(req.op, req.n, req.payload.dtype.str)].append(i)
    bad_v = bad_i = 0
    for (op, _, _), members in sorted(groups.items()):
        for lo in range(0, len(members), BLOCK_ROWS):
            block = members[lo:lo + BLOCK_ROWS]
            pay = np.stack([requests[i].payload for i in block])
            u = np.stack([encode(requests[i].payload) for i in block])
            order = _orders(u, op == "topk", device)
            if op == "sort":
                want = np.take_along_axis(pay, order, 1)
                got = [responses[i].values for i in block]
                bad_v += _rows_wrong(got, want)
                bad_i += sum(responses[i].indices is not None for i in block)
            elif op == "argsort":
                want = order.astype(np.int32)
                got = [responses[i].indices for i in block]
                bad_i += _rows_wrong(got, want)
                bad_v += sum(responses[i].values is not None for i in block)
            else:
                for r, i in enumerate(block):
                    k = requests[i].k
                    idx = order[r, :k]
                    bad_v += not _same(responses[i].values, pay[r, idx])
                    bad_i += not _same(responses[i].indices,
                                       idx.astype(np.int32))
    return bad_v, bad_i


def _rows_wrong(got: list, want: np.ndarray) -> int:
    """Rows of ``got`` that differ from ``want``'s, vectorised when every
    row has the expected shape and dtype."""
    ok = [g is not None and np.asarray(g).shape == want.shape[1:]
          and np.asarray(g).dtype == want.dtype for g in got]
    if all(ok):
        stacked = np.stack(got)
        return int((stacked.view(np.uint8).reshape(len(got), -1)
                    != want.view(np.uint8).reshape(len(got), -1))
                   .any(1).sum())
    return sum(not _same(g, w) for g, w in zip(got, want))


def expected_counts(req, config: dict, served_by: str):
    """``(reads, cycles)`` the reference gives the request's row as the
    backend that serves its op holds it; cycles None off the machine."""
    width = pow2_width(req.n, config["min_bucket"])
    row = padded_row(encode(req.payload), req.op, width)
    if served_by in MACHINE:
        stop = pow2_width(req.k, 1) if req.op == "kmin" else None
        return colskip_reads(row, config["w"], config["state_k"], stop)
    return plane_reads(row), None


def check(window: dict, config: dict, *, seed: int, sample: int,
          device) -> tuple[dict, dict]:
    """The run's compared numbers and, per request index, the reference's
    column reads where it computed them (``{index: reads}``)."""
    requests, responses = window["requests"], window["responses"]
    serves = config["guarantees"]["serves"]
    cr_keys = window["cr_keys"]
    missing = sum(r is None for r in responses)
    backend = sum(1 for q, r in zip(requests, responses)
                  if r is not None and r.backend != serves[q.op])
    bad_v, bad_i = _check_answers(requests, responses, device)
    answered = [i for i, r in enumerate(responses) if r is not None]
    keyed = [i for i in answered
             if serves[requests[i].op] not in MACHINE
             or cr_keys[i] is not None]
    keyed_set = set(keyed)
    rest = [i for i in answered if i not in keyed_set]
    rng = np.random.default_rng([int(seed), 4])
    if len(rest) > sample:
        rest = sorted(rng.choice(rest, size=sample, replace=False).tolist())
    memo: dict = {}
    reads: dict[int, int] = {}
    bad_r = bad_c = 0
    for i in sorted(keyed + rest):
        req, resp = requests[i], responses[i]
        by = serves[req.op]
        # the machine's counts depend on the padded row's multiset only
        key = (cr_keys[i], req.n, req.op == "topk",
               req.k if req.op == "kmin" else None) if (
            by in MACHINE and cr_keys[i] is not None) else None
        if key is not None and key in memo:
            want = memo[key]
        else:
            want = expected_counts(req, config, by)
            if key is not None:
                memo[key] = want
        reads[i] = want[0]
        bad_r += resp.column_reads != want[0]
        bad_c += resp.cycles != want[1]
    numbers = {"missing": missing, "backend": backend, "values": bad_v,
               "indices": bad_i, "reads": int(bad_r), "cycles": int(bad_c)}
    return numbers, {"reads": reads, "reads_checked": len(reads),
                     "machine_rows_sampled": len(rest)}


__all__ = ["LIMITS", "check", "expected_counts"]
