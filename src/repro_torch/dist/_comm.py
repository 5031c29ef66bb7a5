"""Named mesh axes and their collectives over ``torch.distributed``.

The port's counterpart of what ``shard_map`` gives the reference's
functions: a bound ``axis_name`` on which ``psum``, ``pmax``, ``pmin``,
``pmean``, ``all_gather``, ``ppermute`` and ``axis_index`` act.  Here the
program is already one process a rank, so a :class:`Mesh` holds a
``DeviceMesh`` over the initialised process group, the process group of
every axis and of every tuple of axes, this rank's coordinates and the
device its tensors live on.  Every function takes the mesh and an axis
name, or a tuple of axis names (major to minor, as jax linearises them),
and acts on this rank's tensor:

  * the reductions return the reduced tensor on every rank of the group;
  * ``all_gather`` stacks the group's tensors on a new leading axis, in
    axis-index order;
  * ``ppermute`` sends along ``(source, destination)`` axis-index pairs; a
    rank that no pair reaches gets zeros, as in jax.

With one rank on an axis every function is the identity (``all_gather``
adds the leading axis), and communicates nothing.  The ``gloo`` backend
does not send CUDA tensors from one process to another, so on a mesh of
``gloo`` ranks that share a card every collective stages its tensor
through the host explicitly (``Mesh.staged``); ``nccl`` takes them
directly.  ``collectives`` counts the calls that communicated, and
``collective_s`` their host time, since import or
:func:`reset_collectives`.

Three of them carry a backward for autograd, the pair that a layer
computed in parts over an axis needs (Megatron's f and g) and the mean
of a loss term:

  * :func:`copy_to` is the identity, and its backward a ``psum``: an input
    replicated over the axis that each rank uses for only its part of the
    work gets the sum of the parts' gradients;
  * :func:`psum_replicated` is a ``psum`` whose backward passes the
    cotangent through, which every rank already holds whole;
  * :func:`pmean_replicated` is a ``pmean`` whose backward passes the
    cotangent through: each rank's gradient is its own term's, and a data
    parallel step's ``pmean`` of the grads makes the mean.
"""

from __future__ import annotations

import itertools
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["AbstractMesh", "Mesh", "all_gather", "axis_index", "axis_size",
           "collective_s", "collectives", "copy_to", "pmax", "pmean",
           "pmean_replicated", "pmin", "ppermute", "psum",
           "psum_replicated", "reset_collectives"]

collectives = 0
collective_s = 0.0


def reset_collectives() -> None:
    global collectives, collective_s
    collectives, collective_s = 0, 0.0


class AbstractMesh:
    """Axis names and sizes only, like jax's ``AbstractMesh``: what the
    sharding rules read, with no process group behind it."""

    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


class Mesh(AbstractMesh):
    """Named axes over a ``DeviceMesh`` of the initialised process group.

    ``device`` is where this rank's tensors live (a rank of ``gloo`` on a
    card stages its collectives through the host).  The groups of every
    tuple of two or more axes are made here, on every rank in the same
    order, since ``new_group`` is itself collective; a rank outside the
    mesh (``coords`` None) takes part in that and nothing else."""

    def __init__(self, device_mesh: DeviceMesh, device):
        names = device_mesh.mesh_dim_names
        if names is None:
            raise ValueError("the DeviceMesh needs mesh_dim_names")
        super().__init__(dict(zip(names, device_mesh.mesh.shape)))
        self.device_mesh = device_mesh
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._ranks = device_mesh.mesh
        self._groups = {}
        for r in range(2, len(names) + 1):
            for axes in itertools.combinations(names, r):
                self._groups[axes] = self._make_group(axes)
        coord = device_mesh.get_coordinate()
        # a rank outside the mesh took part in making its groups, and has
        # no coordinates to run its functions with
        self.coords = None if coord is None else dict(zip(names, coord))
        if coord is not None:
            self._groups.update({(a,): device_mesh.get_group(a)
                                 for a in names})

    def _make_group(self, axes):
        # the ranks that differ only in `axes`: one group per coordinate
        # of the other axes, the tuple's dims moved last
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(len(self.axis_names)) if d not in dims]
        n = 1
        for d in dims:
            n *= self._ranks.shape[d]
        parts = self._ranks.permute(rest + dims).reshape(-1, n).tolist()
        mine = None
        for ranks in parts:
            g = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = g
        return mine

    def rank_at(self, coords: dict) -> int:
        """The global rank at ``coords`` (this rank's coordinates on the
        axes that ``coords`` leaves out)."""
        full = {**self.coords, **coords}
        return int(self._ranks[tuple(full[a] for a in self.axis_names)])


def _axes(mesh, axis) -> tuple:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in mesh.shape:
            raise KeyError(f"axis {a!r} not in mesh axes {mesh.axis_names}")
    return axes


def axis_size(mesh, axis) -> int:
    """Ranks on ``axis`` (a name or a tuple of names)."""
    n = 1
    for a in _axes(mesh, axis):
        n *= mesh.shape[a]
    return n


def axis_index(mesh, axis) -> int:
    """This rank's index on ``axis``; a tuple linearises major to minor."""
    return _linear(mesh, _axes(mesh, axis), mesh.coords)


def _group(mesh, axes):
    key = tuple(a for a in mesh.axis_names if a in axes)
    return mesh._groups[key]


def _wire(mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous copy of ``x`` for a collective: on the host
    when the mesh stages (the result goes back with ``.to(x.device)``)."""
    if mesh.staged:
        return x.detach().to("cpu", copy=True)
    return x.detach().clone(memory_format=torch.contiguous_format)


def _count(t0: float) -> None:
    global collectives, collective_s
    collectives += 1
    collective_s += time.perf_counter() - t0


def _reduce(x, mesh, axis, op):
    axes = _axes(mesh, axis)
    if axis_size(mesh, axes) == 1:
        return x
    t0 = time.perf_counter()
    buf = _wire(mesh, x)
    dist.all_reduce(buf, op=op, group=_group(mesh, axes))
    out = buf.to(x.device)
    _count(t0)
    return out


def psum(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Sum over ``axis``, on every rank of the group."""
    return _reduce(x, mesh, axis, dist.ReduceOp.SUM)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.mesh, ctx.axis), None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        return pmean(x, mesh, axis) if mean else psum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def copy_to(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``x`` itself; under autograd its gradient is ``psum``-ed over
    ``axis`` (one collective a backward)."""
    if axis_size(mesh, axis) == 1 or not torch.is_grad_enabled():
        return x
    return _CopyTo.apply(x, mesh, axis)


def psum_replicated(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """:func:`psum`; under autograd the cotangent, replicated over
    ``axis``, passes through."""
    if not torch.is_grad_enabled():
        return psum(x, mesh, axis)
    return _Replicated.apply(x, mesh, axis, False)


def pmean_replicated(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """:func:`pmean`; under autograd the cotangent passes through."""
    if not torch.is_grad_enabled():
        return pmean(x, mesh, axis)
    return _Replicated.apply(x, mesh, axis, True)


def pmax(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX)


def pmin(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    return _reduce(x, mesh, axis, dist.ReduceOp.MIN)


def pmean(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Mean over ``axis``: the sum divided by the axis size, as jax's."""
    n = axis_size(mesh, axis)
    return x if n == 1 else psum(x, mesh, axis) / n


def all_gather(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``(n, *x.shape)``: every rank's ``x`` in axis-index order."""
    axes = _axes(mesh, axis)
    n = axis_size(mesh, axes)
    if n == 1:
        return x[None]
    t0 = time.perf_counter()
    buf = _wire(mesh, x)
    parts = [torch.empty_like(buf) for _ in range(n)]
    group = _group(mesh, axes)
    dist.all_gather(parts, buf, group=group)
    # the group's ranks come in global-rank order, which is the mesh's
    # axis order; reorder to the tuple's own linearisation
    ranks = dist.get_process_group_ranks(group)
    coords = [_coords_of(mesh, r) for r in ranks]
    order = sorted(range(n), key=lambda j: _linear(mesh, axes, coords[j]))
    out = torch.stack([parts[j] for j in order]).to(x.device)
    _count(t0)
    return out


def _coords_of(mesh, rank: int) -> dict:
    where = (mesh._ranks == rank).nonzero()[0].tolist()
    return dict(zip(mesh.axis_names, where))


def _linear(mesh, axes, coords: dict) -> int:
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + coords[a]
    return i


def _at_index(mesh, axes, index: int) -> int:
    """The global rank at ``index`` on ``axes`` (this rank's coordinates
    elsewhere)."""
    coords = {}
    for a in reversed(axes):
        index, coords[a] = divmod(index, mesh.shape[a])
    return mesh.rank_at(coords)


def ppermute(x: torch.Tensor, mesh, axis, perm) -> torch.Tensor:
    """Send this rank's ``x`` along ``perm``, ``(source, destination)``
    pairs of axis indices (each source and each destination at most
    once); returns what this rank received, zeros if no pair reaches
    it."""
    axes = _axes(mesh, axis)
    perm = [(int(s), int(d)) for s, d in perm]
    me = axis_index(mesh, axes)
    send = [d for s, d in perm if s == me]
    recv = [s for s, d in perm if d == me]
    if axis_size(mesh, axes) == 1:
        return x.clone() if recv else torch.zeros_like(x)
    t0 = time.perf_counter()
    buf = _wire(mesh, x)
    out = torch.zeros_like(buf)
    ops = []
    group = _group(mesh, axes)
    for d in send:
        if d == me:
            out.copy_(buf)
        else:
            ops.append(dist.P2POp(dist.isend, buf, _at_index(mesh, axes, d),
                                  group))
    for src in recv:
        if src != me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  _at_index(mesh, axes, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = out.to(x.device)
    _count(t0)
    return out
