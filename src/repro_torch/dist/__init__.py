"""`repro_torch.dist` — the distributed layer of the port.

The torch port of :mod:`repro.dist`, one module so far:

  * :mod:`repro_torch.dist.bankmesh` — ``MeshBankPool``: the sortserve
    bank pool whose shard groups run the §IV multi-bank manager.  On the
    card the banks are the CTAs of one thread-block cluster, the manager's
    OR-gates a distributed-shared-memory exchange behind a cluster
    barrier (``kernels/colskip/csrc/colskip_mesh.cu``); on the CPU they
    are bank-stacked rows of the plain machine.

``sharding``, ``compress`` and ``pipeline`` (and ``core/distsort``) have
no user until the model stack is ported, and come with it.
"""

from .bankmesh import (
    MeshBankPool,
    collective_rounds,
    colskip_sort_mesh,
    make_bank_mesh,
    topology_fingerprint,
)

__all__ = [
    "MeshBankPool",
    "collective_rounds",
    "colskip_sort_mesh",
    "make_bank_mesh",
    "topology_fingerprint",
]
