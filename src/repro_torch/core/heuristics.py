"""Baseline topological-ordering heuristics.

``kahn``   — Kahn's algorithm with FIFO tie-break (the paper's tau_max source
             and its stand-in for TensorFlow Lite's allocation-order
             execution, which runs nodes in flatbuffer/topological order).
``dfs``    — depth-first post-order (what many graph exporters emit).
``greedy`` — memory-aware greedy: from the current zero-indegree frontier pick
             the node minimizing the footprint after its deallocations (ties:
             smaller resulting peak, then id).  A strong non-optimal baseline.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Sequence

from repro_torch.core.graph import Graph, simulate_schedule
from repro_torch.core.scheduler import ScheduleResult


def _result(g: Graph, order: list[int], preplaced: Sequence[int]) -> ScheduleResult:
    sim = simulate_schedule(g, order, preplaced=preplaced)
    return ScheduleResult(
        order=order,
        peak_bytes=sim.peak_bytes,
        final_bytes=sim.final_bytes,
        n_states_expanded=len(order),
        n_signatures=len(order),
        wall_time_s=0.0,
        exact=False,
    )


def kahn_schedule(g: Graph, preplaced: Sequence[int] = ()) -> ScheduleResult:
    pre = set(preplaced)
    indeg = [0] * len(g)
    for nd in g.nodes:
        indeg[nd.id] = sum(1 for p in nd.preds if p not in pre)
    q = deque(
        i for i in range(len(g)) if i not in pre and indeg[i] == 0
    )
    order: list[int] = []
    while q:
        u = q.popleft()
        order.append(u)
        for v in g.succs[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                q.append(v)
    return _result(g, order, preplaced)


def dfs_schedule(g: Graph, preplaced: Sequence[int] = ()) -> ScheduleResult:
    pre = set(preplaced)
    seen = set(pre)
    order: list[int] = []

    def visit(u: int) -> None:
        if u in seen:
            return
        seen.add(u)
        for p in g.nodes[u].preds:
            visit(p)
        order.append(u)

    for x in sorted(set(range(len(g))) - pre):
        visit(x)
    return _result(g, order, preplaced)


def greedy_schedule(g: Graph, preplaced: Sequence[int] = ()) -> ScheduleResult:
    """Pick, at every step, the frontier node with the best immediate footprint."""
    pre = set(preplaced)
    n = len(g)
    indeg = [0] * n
    for nd in g.nodes:
        indeg[nd.id] = sum(1 for p in nd.preds if p not in pre)
    remaining = [len(g.succs[i]) for i in range(n)]
    resident = set(pre)
    mu = sum(g.sizes[p] for p in pre)
    frontier = {i for i in range(n) if i not in pre and indeg[i] == 0}
    order: list[int] = []
    while frontier:
        best_u, best_key = -1, None
        for u in sorted(frontier):
            nd = g.nodes[u]
            alias = sum(g.sizes[p] for p in nd.alias_preds)
            peak_u = mu + g.sizes[u] - alias
            mu_u = peak_u
            for p in nd.preds:
                if remaining[p] == 1 and p in resident and p not in nd.alias_preds:
                    mu_u -= g.sizes[p]
            key = (mu_u, peak_u, u)
            if best_key is None or key < best_key:
                best_key, best_u = key, u
        u = best_u
        nd = g.nodes[u]
        mu += g.sizes[u] - sum(g.sizes[p] for p in nd.alias_preds)
        resident.add(u)
        for p in nd.preds:
            remaining[p] -= 1
            if remaining[p] == 0 and p in resident:
                resident.discard(p)
                if p not in nd.alias_preds:
                    mu -= g.sizes[p]
        order.append(u)
        frontier.discard(u)
        for v in g.succs[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                frontier.add(v)
    return _result(g, order, preplaced)


def best_heuristic_schedule(
    g: Graph, preplaced: Sequence[int] = ()
) -> ScheduleResult:
    """The tightest heuristic order: min peak over Kahn / greedy / DFS.

    Used by the DP's branch-and-bound layer as the search incumbent
    (DESIGN.md §8): each order is feasible, so its peak upper-bounds the
    optimum and every state that provably cannot beat it is pruned.
    """
    best: ScheduleResult | None = None
    for fn in (kahn_schedule, greedy_schedule, dfs_schedule):
        res = fn(g, preplaced=preplaced)
        if best is None or res.peak_bytes < best.peak_bytes:
            best = res
    return best


BASELINES: dict[str, Callable[..., ScheduleResult]] = {
    "kahn": kahn_schedule,
    "tflite": kahn_schedule,   # TFLite executes in graph/topo order (DESIGN.md §3)
    "dfs": dfs_schedule,
    "greedy": greedy_schedule,
}
