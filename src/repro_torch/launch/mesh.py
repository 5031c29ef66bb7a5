"""Mesh builders over ``torch.distributed``, and a launcher of ranks.

The port of ``repro/launch/mesh.py``.  The reference's meshes are views of
the devices one process sees; here each rank is a process, so the meshes
are built over an initialised process group (every rank calls the
builder, since making a group is collective), and :func:`spawn` starts
the ranks: ``world`` processes by ``torch.multiprocessing``'s ``spawn``
method, each joining a group on an explicit backend through a
``file://`` store in a fresh temporary directory (no fixed port to
collide with a neighbour's).  Ranks that share one card join ``gloo``
and stage their collectives through the host (:mod:`repro_torch.dist._comm`);
``nccl`` takes one card a rank.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch._device import resolve_device
from repro_torch.dist._comm import Mesh

__all__ = ["make_host_mesh", "make_mesh", "make_production_mesh", "spawn"]


def _device_of(device):
    """This rank's device: ``device`` as given, or, for a bare ``"cuda"``,
    the rank's card (``rank % device_count``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def make_mesh(shape, axis_names, *, device="cuda") -> Mesh:
    """A :class:`~repro_torch.dist._comm.Mesh` of ``shape`` over the first
    ``prod(shape)`` ranks of the initialised group, axes ``axis_names``,
    this rank's tensors on ``device``."""
    dev = _device_of(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: initialise one (or start the "
                           "ranks with repro_torch.launch.mesh.spawn) first")
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    if n > dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    ranks = torch.arange(n).reshape(shape)
    return Mesh(DeviceMesh(dev.type, ranks, mesh_dim_names=tuple(axis_names)),
                dev)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16x16 single pod (256 ranks) or 2x16x16 (512 ranks, 2 pods); the
    group must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != want:
        raise ValueError(f"the production mesh {shape} needs a group of "
                         f"{want} ranks, not {world}")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cuda") -> Mesh:
    """A small ``(data, model)`` mesh over however many ranks exist,
    clamped as the reference clamps to its devices."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    return make_mesh((data, model), ("data", "model"), device=device)


def _rank_main(rank, fn, world, backend, device, tmp, timeout_s, args):
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def spawn(fn, world: int, *, backend: str, device: str, args=(),
          timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on ``world`` new processes, each a rank of a
    fresh process group on ``backend`` with its tensors on ``device``
    (``"cuda:0"``: every rank on that card; ``"cuda"``: one card a rank);
    returns each rank's return value (saved with ``torch.save``), in rank
    order.  ``fn`` must be importable by name (a module's function).  A
    rank that raises ends the others and raises here."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world, backend, str(device), tmp,
                              timeout_s, tuple(args)),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
