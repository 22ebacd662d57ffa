"""Runtime of the port: the budgeted arena pool, the fault DSL, the
fault-tolerant training loop, the sharded serving fleet and its open-loop
load generator.

Copies of ``repro.runtime.pool``, ``repro.runtime.chaos``,
``repro.runtime.fault``, ``repro.runtime.fleet`` and
``repro.runtime.loadgen`` (none imports JAX; ``fault`` checkpoints through
``repro_torch.checkpoint``).
"""

from repro_torch.runtime.chaos import (
    ChaosController,
    FaultPlan,
    FaultSpec,
    TransientExecutorError,
    seeded_corpus,
)
from repro_torch.runtime.fault import FaultTolerantLoop, StepTimer
from repro_torch.runtime.fleet import (
    Fleet,
    FleetRequest,
    FleetRouter,
    FleetStallError,
    PlannerService,
    PlanRecord,
    WorkerShard,
)
from repro_torch.runtime.loadgen import (
    Arrival,
    OpenLoopLoadGen,
    workload_summary,
)
from repro_torch.runtime.pool import (
    ArenaPool,
    Lease,
    LeaseError,
    PoolError,
    PoolStats,
    PreemptionStats,
    ScratchReservation,
    SpilledLease,
    Ticket,
)

__all__ = [
    "ArenaPool",
    "Arrival",
    "ChaosController",
    "FaultPlan",
    "FaultSpec",
    "FaultTolerantLoop",
    "Fleet",
    "FleetRequest",
    "FleetRouter",
    "FleetStallError",
    "Lease",
    "LeaseError",
    "OpenLoopLoadGen",
    "PlanRecord",
    "PlannerService",
    "PoolError",
    "PoolStats",
    "PreemptionStats",
    "ScratchReservation",
    "SpilledLease",
    "StepTimer",
    "Ticket",
    "TransientExecutorError",
    "WorkerShard",
    "seeded_corpus",
    "workload_summary",
]
