"""Differential oracle for the width-W latency x memory Pareto frontier.

A copy of ``src/repro/core/ilp_oracle.py`` without its ILP leg: exact
memoized *suffix* enumeration over scheduled-set masks, for graphs of at
most ``max_nodes`` (default 10) nodes, used by the tests to check that
``pareto_schedule``'s frontier is exactly the set of non-dominated
(makespan, peak-bytes) points under the time-slot scheduling model of
DESIGN.md §12 -- the same role ``brute_force_schedule`` plays for the
serial peak.  Deliberately independent of the forward planner's
machinery: the footprint of a mask is re-derived from scratch as the sum
of live tensor sizes (produced, and either a graph output or still
awaiting a consumer) instead of incrementally, there are no bounds, no
incumbents, and no eager-move dominance.

``repro``'s ILP leg (``solver='pulp'``, the time-indexed formulation)
needs the ``pulp`` package, which the port does not depend on; without
it ``repro``'s ``solver='auto'`` takes this same enumeration.
"""

from __future__ import annotations

import itertools
from typing import Sequence

from repro_torch.core.graph import Graph

__all__ = [
    "OracleError",
    "oracle_frontier",
]

#: the fallback enumerates all 2^n scheduled-set masks; tiny by contract
_FALLBACK_MAX_NODES = 10


class OracleError(RuntimeError):
    """The requested oracle backend is unavailable or out of scope."""


def _node_tables(
    g: Graph, costs: Sequence[int] | None
) -> tuple[list[int], list[int]]:
    """(costs, alloc_pos) re-derived from the graph."""
    if costs is None:
        from repro_torch.core.scheduler import node_costs

        costs = node_costs(g)
    pos = [max(g.sizes[u] - sum(g.sizes[p] for p in g.nodes[u].alias_preds),
               0) for u in range(len(g))]
    return list(costs), pos


def _nondominated(
    points: set[tuple[int, int]] | list[tuple[int, int]]
) -> tuple[tuple[int, int], ...]:
    """Strictly non-dominated (makespan, peak) points, sorted by makespan."""
    out: list[tuple[int, int]] = []
    for ms, pk in sorted(set(points)):
        # kept peaks are strictly decreasing, so the last kept point has the
        # lowest peak seen: anything not strictly below it is dominated (or
        # an equal-makespan tie whose lower-peak twin is already kept)
        if not out or pk < out[-1][1]:
            out.append((ms, pk))
    return tuple(out)


# ---------------------------------------------------------------------------
# Memoized suffix enumeration over masks
# ---------------------------------------------------------------------------


def _fallback_frontier(
    g: Graph,
    max_width: int,
    preplaced: Sequence[int],
    costs: Sequence[int],
    pos: Sequence[int],
    max_nodes: int,
) -> tuple[tuple[int, int], ...]:
    n = len(g)
    if n > max_nodes:
        raise OracleError(
            f"fallback oracle enumerates all masks: {n} nodes > "
            f"max_nodes {max_nodes}")
    pre = frozenset(preplaced)
    pre_mask = 0
    mu0 = 0
    for p in pre:
        pre_mask |= 1 << p
        mu0 += g.sizes[p]
    full_mask = pre_mask
    for u in range(n):
        full_mask |= 1 << u
    succ_mask = g.succ_mask
    pred_mask = g.pred_mask
    sizes = g.sizes

    def footprint(mask: int) -> int:
        # from-scratch live-set sum: a produced tensor is resident while it
        # is a graph output or still has an unscheduled consumer (an
        # alias-consumed pred's storage morphs into its consumer's, which
        # this counts exactly once via the consumer's own size)
        total = 0
        for v in range(n):
            if not mask >> v & 1:
                continue
            if succ_mask[v] == 0 or succ_mask[v] & ~mask:
                total += sizes[v]
        return total

    def ready(mask: int) -> list[int]:
        return [u for u in range(n)
                if not mask >> u & 1 and pred_mask[u] & mask == pred_mask[u]]

    memo: dict[int, tuple[tuple[int, int], ...]] = {}

    def suffix(mask: int) -> tuple[tuple[int, int], ...]:
        """Pareto set of (remaining makespan, absolute suffix peak)."""
        if mask == full_mask:
            return ((0, 0),)
        hit = memo.get(mask)
        if hit is not None:
            return hit
        mu = footprint(mask)
        rdy = ready(mask)
        acc: set[tuple[int, int]] = set()
        for size in range(1, min(max_width, len(rdy)) + 1):
            for S in itertools.combinations(rdy, size):
                dur = max(costs[u] for u in S)
                transient = mu + sum(pos[u] for u in S)
                nm = mask
                for u in S:
                    nm |= 1 << u
                for ms_rest, pk_rest in suffix(nm):
                    acc.add((dur + ms_rest, max(transient, pk_rest)))
        res = _nondominated(acc)
        memo[mask] = res
        return res

    return _nondominated(
        [(ms, max(pk, mu0)) for ms, pk in suffix(pre_mask)])


def oracle_frontier(
    g: Graph,
    *,
    max_width: int,
    preplaced: Sequence[int] = (),
    costs: Sequence[int] | None = None,
    latency_budget: int | None = None,
    max_nodes: int = _FALLBACK_MAX_NODES,
) -> tuple[tuple[int, int], ...]:
    """Exact (makespan, peak_bytes) frontier by suffix enumeration, the
    points above ``latency_budget`` dropped; raises :class:`OracleError`
    for a graph of more than ``max_nodes`` nodes."""
    costs, pos = _node_tables(g, costs)
    pts = _fallback_frontier(g, max_width, preplaced, costs, pos, max_nodes)
    if latency_budget is not None:
        pts = tuple(p for p in pts if p[0] <= latency_budget)
    return pts
