"""`repro_torch.dist` — the distributed layer of the port.

The paper's §IV multi-bank manager combines per-bank bit-plane predicates
through OR-gates so C banks behave as one sorter; ``core/distsort.py``
realises that circuit as collectives over ranks.  This package puts those
collectives to work, one process a rank, on ``torch.distributed``:

  * :mod:`repro_torch.dist._comm` — named mesh axes over a ``DeviceMesh``
    and the collectives the reference's ``shard_map`` bodies call
    (``psum``, ``pmax``, ``pmin``, ``pmean``, ``all_gather``,
    ``ppermute``, ``axis_index``);
  * :mod:`repro_torch.dist.sharding` — placement rules for the model zoo
    (params, activations, caches);
  * :mod:`repro_torch.dist.compress` — error-feedback top-k gradient
    compression whose global threshold is the multi-bank OR-gate;
  * :mod:`repro_torch.dist.pipeline` — GPipe-style stage pipelining over a
    mesh axis (a ``ppermute`` ring);
  * :mod:`repro_torch.dist.bankmesh` — ``MeshBankPool``: the sortserve bank
    pool whose shard groups run the §IV manager on one card, the banks the
    CTAs of a thread-block cluster (``kernels/colskip/csrc/colskip_mesh.cu``),
    on the CPU the bank-stacked rows of the plain machine.

:func:`repro_torch.launch.mesh.spawn` starts the ranks and
``launch/mesh.py`` builds their meshes.
"""

from .bankmesh import (
    MeshBankPool,
    collective_rounds,
    colskip_sort_mesh,
    make_bank_mesh,
    topology_fingerprint,
)
from .compress import ef_topk_psum, ef_topk_psum_auto, ef_topk_psum_tree
from .pipeline import make_pipelined_fn
from .sharding import act_specs, cache_spec, dp_axes, param_specs

__all__ = [
    "MeshBankPool",
    "act_specs",
    "cache_spec",
    "collective_rounds",
    "colskip_sort_mesh",
    "dp_axes",
    "ef_topk_psum",
    "ef_topk_psum_auto",
    "ef_topk_psum_tree",
    "make_bank_mesh",
    "make_pipelined_fn",
    "param_specs",
    "topology_fingerprint",
]
