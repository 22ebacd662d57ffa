"""RandWire random network graphs (Xie et al., ICCV 2019) as SERENITY graphs.

RandWire's published recipe: Watts–Strogatz WS(N=32, K=4, P=0.75) random
graphs, converted to DAGs by orienting every edge from lower to higher node
id.  Each graph node is a ReLU -> separable-conv -> BN triplet whose inputs
are aggregated by a learned weighted sum; nodes with no in-edges read the
stage input, nodes with no out-edges average into the stage output.

CIFAR regime (the paper's RandWire rows): 32x32 images, small channel count
(C=78 for the CIFAR10 model, C=154 for CIFAR100), first stage at 16x16.

``randwire_graph``   — one WS stage (the paper's scheduling benchmark).
``randwire_network`` — a *stacked* network of ``n_cells`` WS stages chained
through per-stage 1x1 projections, the full-network workload for the
hierarchical scheduler: each stage is a partition cell, and with a single
``seed`` every stage is structurally identical, so the isomorphic-cell plan
reuse schedules one cell and replays it (DESIGN.md §8).
"""

from __future__ import annotations

import random
from typing import Sequence

from repro_torch.core.graph import Graph


def _watts_strogatz_edges(n: int, k: int, p: float,
                          rng: random.Random) -> set[tuple[int, int]]:
    """networkx's ``watts_strogatz_graph`` on ``range(n)``, as an edge set.

    The same draws from ``rng`` in the same order, so one seed gives the
    edge set networkx gives (networkx is not a dependency of this package).
    """
    if k > n:
        raise ValueError("k>n, choose smaller k or larger n")
    if k == n:
        return {(u, v) for u in range(n) for v in range(u + 1, n)}
    adj: list[set[int]] = [set() for _ in range(n)]
    nodes = list(range(n))
    for j in range(1, k // 2 + 1):          # the ring lattice
        for u, v in zip(nodes, nodes[j:] + nodes[:j]):
            adj[u].add(v)
            adj[v].add(u)
    for j in range(1, k // 2 + 1):          # rewire, neighbor distance outer
        for u, v in zip(nodes, nodes[j:] + nodes[:j]):
            if rng.random() < p:
                w = rng.choice(nodes)
                while w == u or w in adj[u]:
                    w = rng.choice(nodes)
                    if len(adj[u]) >= n - 1:
                        break               # skip this rewiring
                else:
                    adj[u].discard(v)
                    adj[v].discard(u)
                    adj[u].add(w)
                    adj[w].add(u)
    return {(u, v) for u in range(n) for v in adj[u] if u < v}


def _is_connected(n: int, edges: set[tuple[int, int]]) -> bool:
    adj: list[list[int]] = [[] for _ in range(n)]
    for u, v in edges:
        adj[u].append(v)
        adj[v].append(u)
    seen, stack = {0}, [0]
    while stack:
        for v in adj[stack.pop()]:
            if v not in seen:
                seen.add(v)
                stack.append(v)
    return len(seen) == n


def connected_watts_strogatz_edges(n: int, k: int, p: float, seed: int,
                                   tries: int = 100) -> set[tuple[int, int]]:
    """networkx's ``connected_watts_strogatz_graph(n, k, p, seed=seed)``:
    redraw with one ``random.Random(seed)`` until the graph is connected."""
    rng = random.Random(seed)
    for _ in range(tries):
        edges = _watts_strogatz_edges(n, k, p, rng)
        if _is_connected(n, edges):
            return edges
    raise ValueError("Maximum number of tries exceeded")


def _ws_dag_preds(seed: int, n: int, k: int, p: float) -> dict[int, list[int]]:
    """WS(n, k, p) oriented low->high id: per-node DAG predecessor lists."""
    dag_edges = sorted(connected_watts_strogatz_edges(n, k, p, seed))
    preds: dict[int, list[int]] = {i: [] for i in range(n)}
    for u, v in dag_edges:
        preds[v].append(u)
    return preds


def _add_stage(
    specs: list[dict],
    stage_in: int,
    *,
    seed: int,
    n: int,
    k: int,
    p: float,
    fmap: int,
    sep_w: int,
    prefix: str = "",
) -> int:
    """Append one WS stage reading ``stage_in``; returns the mean node id."""
    preds = _ws_dag_preds(seed, n, k, p)

    def add(name, op, size, pr=(), weight=0):
        specs.append(dict(name=name, op=op, size_bytes=size, preds=list(pr),
                          weight_bytes=weight))
        return len(specs) - 1

    # One IR node per RandWire node — the paper's scheduling granularity:
    # weighted-sum + ReLU + sepconv + BN fuse into the node (the fused
    # intermediates are same-sized as the output and die within the op).
    out_of: dict[int, int] = {}
    for v in range(n):
        srcs = [out_of[u] for u in sorted(preds[v])] or [stage_in]
        out_of[v] = add(f"{prefix}n{v}.sepconv", "conv", fmap, srcs,
                        weight=sep_w)
    # nodes with no out-edges in the DAG feed the stage output:
    has_out = {u for v in range(n) for u in preds[v]}
    sinks = [out_of[v] for v in range(n) if v not in has_out]
    return add(f"{prefix}stage_out.mean", "add", fmap, sinks)


def randwire_graph(
    seed: int = 10,
    n: int = 32,
    k: int = 4,
    p: float = 0.75,
    hw: int = 16,
    channels: int | None = None,
    dtype_bytes: int = 4,
) -> Graph:
    if channels is None:
        channels = 78 if seed % 2 == 0 else 109
    fmap = hw * hw * channels * dtype_bytes
    sep_w = (channels * 9 + channels * channels) * dtype_bytes
    specs: list[dict] = []
    specs.append(dict(name="stage_in", op="input", size_bytes=fmap, preds=[],
                      weight_bytes=0))
    mean = _add_stage(specs, 0, seed=seed, n=n, k=k, p=p, fmap=fmap,
                      sep_w=sep_w)
    specs.append(dict(name="stage_out.pw", op="conv", size_bytes=fmap,
                      preds=[mean],
                      weight_bytes=channels * channels * dtype_bytes))
    return Graph.build(specs, name=f"randwire_ws{n}_{k}_{seed}")


def randwire_network(
    n_cells: int = 8,
    seed: int | Sequence[int] = 10,
    n: int = 32,
    k: int = 4,
    p: float = 0.75,
    hw: int = 16,
    channels: int | None = None,
    dtype_bytes: int = 4,
) -> Graph:
    """A stacked RandWire network: ``n_cells`` WS stages chained end to end.

    Each stage is the :func:`randwire_graph` cell (one WS random graph
    aggregated by a mean and projected by a 1x1 conv); stage ``i+1`` reads
    stage ``i``'s projection.  With a scalar ``seed`` every stage shares the
    wiring — the weight-shared repeated-cell deployment NAS networks use —
    so the partition tree's leaves are isomorphic and the scheduler plans
    one cell and replays it for the rest.  Pass a sequence of seeds for
    per-stage random wiring (every cell then schedules independently).

    ``n_cells=8, n=32`` gives a 274-node network — the ≥200-node
    full-network workload the scheduling-time benchmarks track.
    """
    seeds = list(seed) if isinstance(seed, (list, tuple)) else [seed] * n_cells
    if len(seeds) != n_cells:
        raise ValueError(f"need {n_cells} seeds, got {len(seeds)}")
    if channels is None:
        channels = 78 if seeds[0] % 2 == 0 else 109
    fmap = hw * hw * channels * dtype_bytes
    sep_w = (channels * 9 + channels * channels) * dtype_bytes
    specs: list[dict] = []
    specs.append(dict(name="stem", op="input", size_bytes=fmap, preds=[],
                      weight_bytes=0))
    x = 0
    for ci, s in enumerate(seeds):
        mean = _add_stage(specs, x, seed=s, n=n, k=k, p=p, fmap=fmap,
                          sep_w=sep_w, prefix=f"c{ci}.")
        specs.append(dict(name=f"c{ci}.pw", op="conv", size_bytes=fmap,
                          preds=[mean],
                          weight_bytes=channels * channels * dtype_bytes))
        x = len(specs) - 1
    specs.append(dict(name="head.pool", op="pool",
                      size_bytes=channels * dtype_bytes, preds=[x]))
    tag = f"s{seeds[0]}" if len(set(seeds)) == 1 else "mix"
    return Graph.build(specs, name=f"randwire_net_ws{n}_{k}_x{n_cells}_{tag}")
