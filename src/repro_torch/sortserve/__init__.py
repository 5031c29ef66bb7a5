"""sortserve — sort-as-a-service over the column-skipping engines.

The torch port of :mod:`repro.sortserve`; the backends run the port's
CUDA kernels.

The paper's §IV multi-bank manager turns one physical sorter into a pool of
synchronized sub-sorters; this package applies the same structure one level
up, turning the repo's sorting engines into a request-level service:

  * :mod:`request`   — typed request/response API (sort / argsort / topk /
    kmin over uint/int/float payloads of heterogeneous lengths),
  * :mod:`batcher`   — pow-2 shape bucketing with sentinel padding in the
    order-preserving sortable-uint32 domain, coalescing requests into fixed
    ``(B, N)`` tiles so launcher caches stay warm,
  * :mod:`scheduler` — the bank-pool scheduler modeled on the §IV manager:
    per-bank occupancy, OR-combined readiness, oversized tiles sharded
    across banks; the event-driven
    :class:`~repro_torch.sortserve.scheduler.ContinuousScheduler` admits tiles
    the moment banks drain, with a pluggable
    :class:`~repro_torch.sortserve.scheduler.AdmissionPolicy` (watermark
    backpressure: accept / defer / shed) gating arrivals under overload,
  * :mod:`backends`  — pluggable execution backends (colskip, radix_topk,
    jaxsort, numpy oracle) behind a cost-model-driven selection policy with
    per-traffic-class measured priors,
  * :mod:`engine`    — streaming sessions
    (``begin(traffic_class=...)/feed()/drain()``), the batch ``submit``
    wrapper, the bounded async front door (:class:`RetryAfter`
    backpressure + :class:`BackoffPolicy` client-side retry), and JSON
    telemetry (latency, column reads / cycles, bucket hit rates,
    event-clock admission + overload stats),
  * :mod:`faults`    — seeded bank fault injection (:class:`FaultPlan`),
    the result-verification guard, and the :class:`BankHealth`
    quarantine/probation tracker behind ``EngineConfig(faults=...)``,
  * :mod:`fleet`     — N engine replicas behind a telemetry-driven
    :class:`FleetRouter` (failover, shed redirect, rolling restart) and
    the versioned warm-state artifact shared with the reference package.
"""

from .backends import BACKENDS, CostPolicy, resolve_backends, solve_numpy
from .batcher import Batcher, Tile, pow2_bucket
from .engine import (
    AsyncSortServe,
    BackoffPolicy,
    EngineConfig,
    RetryAfter,
    SortServeEngine,
    SortSession,
)
from .fleet import (
    WARM_STATE_VERSION,
    FleetError,
    FleetRouter,
    FleetSaturated,
    NoReplicaAvailable,
    WarmStateError,
    load_warm_state,
    merge_warm_states,
    save_warm_state,
)
from .faults import (
    BankDeadError,
    BankHealth,
    CorruptResultError,
    FaultError,
    FaultInjector,
    FaultPlan,
    RecoveryPolicy,
    TransientFaultError,
    verify_tile_result,
)
from .request import OP_KINDS, SortRequest, SortResponse, encode_payload
from .scheduler import (
    AdmissionPolicy,
    BankPool,
    ContinuousScheduler,
    ShedError,
    WatermarkPolicy,
)

__all__ = [
    "AdmissionPolicy",
    "AsyncSortServe",
    "BACKENDS",
    "BackoffPolicy",
    "BankDeadError",
    "BankHealth",
    "BankPool",
    "Batcher",
    "ContinuousScheduler",
    "CorruptResultError",
    "CostPolicy",
    "EngineConfig",
    "FaultError",
    "FaultInjector",
    "FaultPlan",
    "FleetError",
    "FleetRouter",
    "FleetSaturated",
    "NoReplicaAvailable",
    "OP_KINDS",
    "RecoveryPolicy",
    "RetryAfter",
    "ShedError",
    "SortRequest",
    "SortResponse",
    "SortServeEngine",
    "SortSession",
    "Tile",
    "TransientFaultError",
    "WARM_STATE_VERSION",
    "WarmStateError",
    "WatermarkPolicy",
    "encode_payload",
    "load_warm_state",
    "merge_warm_states",
    "pow2_bucket",
    "resolve_backends",
    "save_warm_state",
    "solve_numpy",
    "verify_tile_result",
]
