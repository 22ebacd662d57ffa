"""Runtime of the port: the budgeted arena pool, the fault DSL and the
fault-tolerant training loop.

Copies of ``repro.runtime.pool``, ``repro.runtime.chaos`` and
``repro.runtime.fault`` (none imports JAX; ``fault`` checkpoints through
``repro_torch.checkpoint``).  ``fleet`` and ``loadgen`` wait for a later
slice (ROADMAP A4).
"""

from repro_torch.runtime.chaos import (
    ChaosController,
    FaultPlan,
    FaultSpec,
    TransientExecutorError,
    seeded_corpus,
)
from repro_torch.runtime.fault import FaultTolerantLoop, StepTimer
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
    "ChaosController",
    "FaultPlan",
    "FaultSpec",
    "FaultTolerantLoop",
    "Lease",
    "LeaseError",
    "PoolError",
    "PoolStats",
    "PreemptionStats",
    "ScratchReservation",
    "SpilledLease",
    "StepTimer",
    "Ticket",
    "TransientExecutorError",
    "seeded_corpus",
]
