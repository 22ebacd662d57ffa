"""Adaptive soft budgeting (paper Algorithm 2).

A meta-search for the pruning budget tau used by the DP scheduler:

  * tau_max  — peak footprint of Kahn's schedule (always feasible), the
               paper's "hard budget".
  * 'no solution' (tau < mu*)        -> raise tau toward the last feasible one:
        tau_old <- tau_new ; tau_new <- (tau_new + tau_old)/2   (midpoint)
  * 'timeout'  (search step too big) -> lower tau aggressively:
        tau_old <- tau_new ; tau_new <- tau_new/2

Both updates are the paper's, with its "simultaneous" semantics (the midpoint
uses the *previous* tau_old).  The paper's per-step wall-clock limit T is
realized deterministically as a per-step signature quota (``state_quota``);
the literal wall-clock limit is also supported.

Termination: the paper loops until 'solution'.  With integer byte budgets the
interval [best-known-infeasible, best-known-feasible] shrinks monotonically,
but a too-small quota can make *every* tau in the interval time out.  In that
case (interval collapsed without a solution) we escalate the quota (x4) and
restart — with quota -> infinity the search degenerates to the exact DP, so
termination is guaranteed.  This fallback is our addition (DESIGN.md §3).

Every DP round inherits the scheduler's fragmentation-aware tie-break:
among equal-peak signatures the winner is the partial schedule with the
smaller estimated arena watermark, so the tau meta-search converges on
orders the offset allocator can realize without fragmentation (rule and
rationale in DESIGN.md §5).

Since the branch-and-bound rework (DESIGN.md §8) the DP bounds itself with
a heuristic incumbent, so a plain ``dp_schedule`` call already runs with an
automatic, tighter-than-Kahn tau; this meta-search is the *fallback* the
pipeline reaches for when even the bounded search exceeds its state quota
(every round still benefits from the bound: the effective tau is
``min(tau_round, incumbent)`` plus the dominance and lower-bound prunes).
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.core.graph import Graph
from repro_torch.core.heuristics import kahn_schedule
from repro_torch.core.scheduler import (
    NoSolutionError,
    ScheduleResult,
    SearchTimeout,
    dp_schedule,
)


@dataclasses.dataclass
class BudgetSearchStats:
    tau_trajectory: list[tuple[int, str]]      # (tau, flag) per round
    tau_final: int
    tau_max: int
    quota_escalations: int
    wall_time_s: float


def adaptive_budget_schedule(
    g: Graph,
    *,
    state_quota: int = 20_000,
    preplaced: tuple[int, ...] = (),
    max_rounds: int = 64,
    wall_clock_limit_s: float | None = None,
    tau_max: int | None = None,
    engine: str = "auto",
) -> tuple[ScheduleResult, BudgetSearchStats]:
    """Algorithm 2: binary meta-search for tau wrapping the DP scheduler.

    ``tau_max`` defaults to the Kahn peak (the paper's hard budget); callers
    may pass a tighter *known-feasible* peak (e.g. the best heuristic's) —
    since the DP prunes strictly-greater peaks only, a feasible tau never
    yields 'no solution', it just shrinks the search space further.

    ``engine`` selects the DP implementation per round (see
    :func:`repro_torch.core.scheduler.dp_schedule`); every round of the meta-search
    shares the graph's precomputed bitmask tables, so retries with a new tau
    re-run only the frontier sweep, not the setup.
    """
    t0 = time.perf_counter()
    kahn = kahn_schedule(g, preplaced=preplaced)
    if tau_max is None:
        tau_max = kahn.peak_bytes
    trajectory: list[tuple[int, str]] = []
    escalations = 0
    quota = state_quota

    while True:
        tau_old = tau_new = tau_max
        lo_infeasible = -1                  # tightest tau that returned 'no solution'
        result: ScheduleResult | None = None
        for _round in range(max_rounds):
            try:
                result = dp_schedule(
                    g,
                    budget=tau_new,
                    state_quota=quota,
                    preplaced=preplaced,
                    wall_clock_limit_s=wall_clock_limit_s,
                    engine=engine,
                )
                trajectory.append((tau_new, "solution"))
                break
            except SearchTimeout:
                trajectory.append((tau_new, "timeout"))
                tau_old, tau_new = tau_new, tau_new // 2
            except NoSolutionError:
                trajectory.append((tau_new, "no solution"))
                lo_infeasible = max(lo_infeasible, tau_new)
                tau_old, tau_new = tau_new, (tau_new + tau_old) // 2
            # keep tau above the tightest known-infeasible point
            if tau_new <= lo_infeasible:
                tau_new = (lo_infeasible + max(tau_old, lo_infeasible + 2)) // 2 + 1
            if tau_new >= tau_max:
                # interval exhausted under this quota -> escalate
                break
        if result is not None:
            stats = BudgetSearchStats(
                tau_trajectory=trajectory,
                tau_final=trajectory[-1][0],
                tau_max=tau_max,
                quota_escalations=escalations,
                wall_time_s=time.perf_counter() - t0,
            )
            return result, stats
        escalations += 1
        quota *= 4
        if escalations > 12:   # pragmatically unreachable; protects CI
            stats = BudgetSearchStats(
                tau_trajectory=trajectory,
                tau_final=tau_max,
                tau_max=tau_max,
                quota_escalations=escalations,
                wall_time_s=time.perf_counter() - t0,
            )
            return kahn, stats
