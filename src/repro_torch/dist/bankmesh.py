"""Mesh-sharded bank pool: §IV multi-bank management on one card.

The torch port of :mod:`repro.dist.bankmesh`.  The sortserve
:class:`~repro_torch.sortserve.scheduler.BankPool` is a single-process
model of the paper's bank manager — shard groups, drain policy, wave
execution.  This module is its distributed realization: a tile's columns
are split into ``D`` contiguous shards, each one bank of the shard group,
and the column-skipping sort runs with the manager's OR-gates between the
banks, as the reference's ``shard_map`` body does with ``psum`` /
``all_gather``:

  * the mixed-column judgement is **one exchange per fused block of
    planes** (the saw-a-1 / saw-a-0 predicates of every bank, ORed);
  * state-table liveness (SL) is an OR of the per-entry local hit bits;
  * the duplicate drain is bank-major: every bank learns the survivor
    counts of all banks and takes its exclusive prefix.

The chip machine has one card, so a mesh over ``torch.cuda`` devices would
be a mesh of one bank.  The port's banks are therefore the CTAs of one
thread-block cluster on the card (``kernels/colskip/csrc/colskip_mesh.cu``:
a cluster of ``D`` CTAs a row, the gates a distributed-shared-memory
exchange behind a cluster barrier), and on the CPU the bank-stacked rows
of the plain machine (:func:`repro_torch.kernels.colskip.ref.sort_mesh_ref`).
A mesh has 1 to 8 banks (the portable cluster size), 4 by default, the
topology the reference's parity tests force on the CPU.  The reference's
own realization, one bank a process with the gates as collectives, is
:func:`_colskip_tile_local` over the ranks of a
:class:`repro_torch.dist._comm.Mesh` (:func:`sharded_tile_fn`): a
distributed path, not the serving one.

Because §V.C's result — bank management never changes the cycle count —
holds for either realization, :class:`MeshBankPool` telemetry is
bit-identical to the single-process pool, and the backend may fall back to
one bank when a tile's width does not divide over the banks.  The
event-model invariants of the reference hold unchanged: mesh tiles report
the local kernel's modeled cycles (virtual-time units), one tile charges
its cycles to every bank of its shard group (bank-cycle conservation), and
the pool adds no placement state outside ``LogicalBank`` (owner-scoped
abort).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.bitmatrix import as_words, to_uint32
from repro_torch.dist import _comm
from repro_torch.kernels.colskip import ops as colskip_ops
from repro_torch.kernels.colskip.ref import colskip_machine
from repro_torch.sortserve.scheduler import BankPool

__all__ = ["DEFAULT_BANKS", "MAX_BANKS", "BankMesh", "MeshBankPool",
           "collective_rounds", "colskip_sort_mesh", "make_bank_mesh",
           "sharded_tile_fn", "topology_fingerprint"]

DEFAULT_BANKS = 4       # the reference's parity topology (4 host devices)
MAX_BANKS = 8           # the portable thread-block cluster size


class BankMesh:
    """A mesh of banks on one device, shaped like a jax ``Mesh``:
    ``axis_names``, ``shape`` (axis -> size) and ``devices`` (an array of
    bank labels of the mesh's shape: the CTAs of a cluster on the card,
    plain banks on the CPU), plus the torch ``device`` it runs on."""

    def __init__(self, shape: tuple, axis_names: tuple, device: torch.device):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.device = device
        banks = math.prod(shape)
        if device.type == "cuda":
            index = (device.index if device.index is not None
                     else torch.cuda.current_device())
            self.device_kind = torch.cuda.get_device_name(index)
            labels = [f"cuda:{index}/cta{i}" for i in range(banks)]
        else:
            self.device_kind = "cpu"
            labels = [f"cpu/bank{i}" for i in range(banks)]
        self.devices = np.array(labels, dtype=object).reshape(shape)

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self):
        return (f"BankMesh({self.shape}, device={self.device}, "
                f"kind={self.device_kind!r})")


def make_bank_mesh(devices=None, axis_name: str = "banks", *,
                   hosts: int = 1, host_axis: str = "hosts",
                   device="cuda") -> BankMesh:
    """Bank mesh of ``devices`` banks: None for :data:`DEFAULT_BANKS`, an
    int, or a list (its length), 1 to :data:`MAX_BANKS`.

    ``hosts=1`` builds the one-axis ``banks`` mesh; ``hosts>1`` folds the
    banks host-major into ``(hosts, D / hosts)`` with axes ``(host_axis,
    axis_name)``, as ``jax.make_mesh`` does.  The flat bank order is the
    same either way, so results are identical; the manager gates reduce
    over every bank of the axes a call names."""
    dev = resolve_device(device)
    if devices is None:
        n = DEFAULT_BANKS
    elif isinstance(devices, int):
        n = devices
    else:
        n = len(list(devices))
    if not 1 <= n <= MAX_BANKS:
        raise ValueError(f"{n} banks: a mesh has 1 to {MAX_BANKS} banks "
                         "(the CTAs of one thread-block cluster)")
    if hosts <= 1:
        return BankMesh((n,), (axis_name,), dev)
    if n % hosts:
        raise ValueError(f"{n} devices not divisible over {hosts} hosts")
    return BankMesh((hosts, n // hosts), (host_axis, axis_name), dev)


def topology_fingerprint(mesh: BankMesh) -> tuple:
    """Hashable identity of a mesh's topology rather than its object: axis
    names and sizes, the device platform and kind, and the bank count.  An
    equal mesh rebuilt after a restart, or built independently by backend
    and pool, fingerprints equal, so launcher caches keyed on it never
    build twice."""
    return (mesh.axis_names, tuple(mesh.devices.shape), mesh.device.type,
            mesh.device_kind, mesh.size)


def _axes_tuple(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def collective_rounds(w: int, stop: int, fuse: int = 1) -> dict:
    """Static per-tile manager-round accounting for the mesh hot path.

    Per §IV iteration: one SL-gate round (load), ``ceil(w / fuse)``
    traverse rounds (each fused block is a single psum), and one drain
    ``all_gather``; plus the 2 assembly psums per tile.  ``planes`` is the
    plane-traversal count the unfused path would pay one round each for —
    ``rounds / planes`` is the mesh-side CR analogue the ``collectives``
    telemetry family reports.
    """
    blocks = -(-w // fuse)
    return {
        "rounds": stop * (blocks + 2) + 2,
        "unfused_rounds": stop * (w + 2) + 2,
        "planes": stop * w,
    }


def mesh_banks(mesh: BankMesh, axis_name) -> int:
    """Banks a call sharding over ``axis_name`` (one axis or a tuple)
    splits a row into."""
    return math.prod(mesh.shape[a] for a in _axes_tuple(axis_name))


def colskip_sort_mesh(x, mesh: BankMesh, *, w: int = 32, k: int = 2,
                      axis_name="banks", stop_after: int | None = None,
                      packed: bool = True, fuse: int = 1,
                      return_rounds: bool = False):
    """Sort rows of ``x`` (B, N) uint32 over the mesh's ``axis_name`` banks.

    Bit-identical to :func:`repro_torch.kernels.colskip.colskip_sort_batched`
    (values, order, and CR/cycle telemetry) — §V.C's invariance of column
    skipping under multi-bank management.  N must divide evenly over the
    axis (the product of sizes when ``axis_name`` is the 2-axis hosts
    tuple); callers fall back to one bank otherwise.  ``packed`` selects
    the mask carrier inside each bank; ``fuse`` batches that many bit
    planes per manager round (results are fuse-invariant).  On the card
    the carrier's mesh kernel runs (``fuse`` in 1 to 8, as
    :data:`repro_torch.kernels.colskip.ops.MESH_FUSES`), on the CPU the
    plain mesh.
    ``return_rounds=True`` adds the (B,) cross-bank exchanges each row
    made on the kernel (None on the CPU).
    """
    b, n = x.shape
    nbanks = mesh_banks(mesh, axis_name)
    if n % nbanks:
        raise ValueError(f"N={n} not divisible over {nbanks} mesh banks")
    stop = n if stop_after is None else min(int(stop_after), n)
    if stop < 1:
        raise ValueError(f"stop_after={stop_after} must be >= 1")
    return colskip_ops.colskip_sort_mesh_batched(
        x, nbanks, w, k, stop_after=stop, packed=packed, fuse=fuse,
        device=mesh.device, return_rounds=return_rounds)


def _colskip_tile_local(u_local, mesh, *, w: int, k: int, stop: int,
                        axis_name, packed: bool = True, fuse: int = 1):
    """This rank's bank of the sharded sort: the reference's
    ``_colskip_tile_local`` (``repro/dist/bankmesh.py:126-181``), one bank a
    process of ``mesh`` (a :class:`repro_torch.dist._comm.Mesh`).

    ``u_local``: (TB, N_local), this bank's column shard of the tile.  The
    §III machine is the port's plain
    :func:`~repro_torch.kernels.colskip.ref.colskip_machine`; the manager's
    combine points are collectives over the bank axes (``("banks",)`` or
    ``("hosts", "banks")``): ``or_any`` a ``psum`` of the predicate bits
    (one a fused block, one a load), ``drain_counts`` an ``all_gather`` of
    the survivor counts with the bank-major prefix, and two ``psum``s
    assemble the output.  Returns ``(values (TB, stop) uint32, order (TB,
    stop) int32, crs (TB,) int32, cycles (TB,) int32)`` on every bank,
    bit-identical to the local machine."""
    u = as_words(torch.as_tensor(u_local))
    tb, n_loc = u.shape
    axes = _axes_tuple(axis_name)
    nbanks = _comm.axis_size(mesh, axes)
    bank = _comm.axis_index(mesh, axes)
    stop = min(stop, n_loc * nbanks)
    dev = u.device

    def or_any(local_bits):
        return _comm.psum(local_bits.to(torch.int32), mesh, axes) > 0

    def drain_counts(m_local):
        m_all = _comm.all_gather(m_local, mesh, axes)            # (C, TB)
        ahead = torch.arange(nbanks, device=dev)[:, None] < bank
        return m_all.sum(0), torch.where(ahead, m_all, 0).sum(0)

    sorted_mask, out_pos, crs, drains = colskip_machine(
        u, w, k, stop, or_any=or_any, drain_counts=drain_counts,
        packed=packed, fuse=fuse)
    # each bank scatters its drained elements into the global (TB, stop)
    # result (zeros elsewhere, a spare column for the undrained); a psum
    # assembles it on every bank
    pos = torch.where(sorted_mask, out_pos, stop)
    cols = bank * n_loc + torch.arange(n_loc, device=dev).expand(tb, n_loc)
    order = torch.zeros((tb, stop + 1), dtype=torch.int64, device=dev)
    vals = torch.zeros((tb, stop + 1), dtype=torch.int64, device=dev)
    order = _comm.psum(order.scatter_(1, pos, cols)[:, :stop], mesh, axes)
    vals = _comm.psum(vals.scatter_(1, pos, u)[:, :stop], mesh, axes)
    return (to_uint32(vals), order.to(torch.int32), crs.to(torch.int32),
            (crs + drains).to(torch.int32))


def sharded_tile_fn(mesh, axis_name, w: int, k: int, stop: int,
                    packed: bool, fuse: int = 1):
    """The sharded tile body over the ranks of ``mesh``: the reference's
    ``sharded_tile_fn``.  Returns ``fn(x)`` for every rank to call with the
    whole (B, N) tile; each rank takes its contiguous column shard (its
    index on ``axis_name``, one axis or the 2-axis hosts tuple) and runs
    :func:`_colskip_tile_local`.  ``fn`` returns the replicated outputs."""
    axes = _axes_tuple(axis_name)

    def fn(x):
        x = torch.as_tensor(x, device=mesh.device)
        n = x.shape[1]
        nbanks = _comm.axis_size(mesh, axes)
        if n % nbanks:
            raise ValueError(f"N={n} not divisible over {nbanks} mesh banks")
        n_loc = n // nbanks
        i = _comm.axis_index(mesh, axes)
        return _colskip_tile_local(x[:, i * n_loc:(i + 1) * n_loc], mesh,
                                   w=w, k=k, stop=stop, axis_name=axes,
                                   packed=packed, fuse=fuse)
    return fn


class MeshBankPool(BankPool):
    """A :class:`BankPool` whose shard groups execute on a bank mesh.

    Placement, readiness gating, the drain policy, and wave execution are
    inherited unchanged — telemetry parity with the single-process pool is
    structural.  What changes is *where* a shard group's mixed-column
    judgement runs: the pool carries a bank mesh, and the ``colskip_mesh``
    backend executes each tile through :func:`colskip_sort_mesh` on it.
    Logical banks and mesh banks are distinct resources: the pool may
    model more banks than the mesh has (several logical banks per mesh
    bank) — the §IV manager does not care, because the cycle count is
    bank-count invariant.
    """

    def __init__(self, banks: int = 8, bank_width: int = 1024,
                 bank_rows: int = 8, devices=None, axis_name: str = "banks",
                 hosts: int = 1, host_axis: str = "hosts", device="cuda"):
        super().__init__(banks, bank_width, bank_rows)
        self.mesh = make_bank_mesh(devices, axis_name, hosts=hosts,
                                   host_axis=host_axis, device=device)
        # the axis spec backends shard over: one name, or the 2-axis tuple
        # when the pool spans a hosts axis
        self.axis_name = (host_axis, axis_name) if hosts > 1 else axis_name

    @property
    def n_devices(self) -> int:
        return mesh_banks(self.mesh, self.axis_name)

    def bank_labels(self) -> list[str]:
        """Trace-export track names carrying the mesh bank each logical
        bank maps onto (banks cycle over the mesh when the pool models more
        banks than the mesh has)."""
        devs = list(self.mesh.devices.flat)
        return [f"bank {b.index} @ {devs[b.index % len(devs)]}"
                for b in self.banks]
