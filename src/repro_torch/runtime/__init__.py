"""Serving runtime of the port: the budgeted arena pool and the fault DSL.

Copies of ``repro.runtime.pool`` and ``repro.runtime.chaos`` (neither
imports JAX).  ``fleet``, ``loadgen`` and ``fault`` wait for a later slice
(ROADMAP A4).
"""

from repro_torch.runtime.chaos import (
    ChaosController,
    FaultPlan,
    FaultSpec,
    TransientExecutorError,
    seeded_corpus,
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
    "ChaosController",
    "FaultPlan",
    "FaultSpec",
    "Lease",
    "LeaseError",
    "PoolError",
    "PoolStats",
    "PreemptionStats",
    "ScratchReservation",
    "SpilledLease",
    "Ticket",
    "TransientExecutorError",
    "seeded_corpus",
]
