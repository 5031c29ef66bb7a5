"""GPipe-style pipeline parallelism over one mesh axis.

The port of ``repro/dist/pipeline.py``.  Each rank holds one stage's
weights; microbatches enter at stage 0, flow stage to stage over a
``ppermute`` ring (one hop a step) and exit at the last stage.  The
schedule is the classic fill, steady and drain pipeline: ``M + S - 1``
steps for ``M`` microbatches over ``S`` stages, every rank busy in the
steady state.  The reference runs the block on don't-care data in the
fill and drain slots and masks it out (uniform control flow under
``scan``); an eager rank knows its slots, so it skips those blocks and
sends zeros.  The outputs are broadcast from the last stage by a ``psum``
(the other stages contribute zeros), as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.dist._comm import axis_index, axis_size, ppermute, psum

__all__ = ["make_pipelined_fn"]


def make_pipelined_fn(mesh, block_fn, axis_name: str):
    """Build ``run(w, xs)``, run on every rank of ``mesh[axis_name]``:
    ``w`` is this stage's weights, ``xs`` the ``(M, ...)`` microbatches
    (read by stage 0 only).  Every rank gets ``run(w, xs)[m] ==
    block_fn(w_{S-1}, ... block_fn(w_0, xs[m]))``."""
    n_stages = axis_size(mesh, axis_name)
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def run(w, xs):
        stage = axis_index(mesh, axis_name)
        m = xs.shape[0]
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(m + n_stages - 1):
            # stage s holds microbatch t - s, if there is one
            if 0 <= t - stage < m:
                y = block_fn(w, xs[t] if stage == 0 else buf)
                if stage == n_stages - 1:
                    outs[t - stage] = y
            else:
                y = torch.zeros_like(buf)
            buf = ppermute(y, mesh, axis_name, perm)
        last = stage == n_stages - 1
        return psum(outs if last else torch.zeros_like(outs), mesh,
                    axis_name)

    return run
