"""Divide-and-conquer over single-node separators (paper Section 3.2, Fig. 7).

Irregularly wired networks from NAS stack single-input/single-output cells
into an hourglass topology.  A node ``v`` is a *separator* iff

  (a) every other node is either a strict ancestor or strict descendant of
      ``v``            (ancestors ∪ {v} ∪ descendants == V), and
  (b) no edge jumps across ``v`` (from a strict ancestor directly to a strict
      descendant) — otherwise that edge's tensor stays live across the cut and
      the sub-schedules would not compose memory-independently.

With both conditions, any schedule factors as (ancestors..., v, descendants...)
and the only tensor live at the cut is v's output, so concatenating per-part
optimal schedules is globally optimal (Wilken et al., 2000 — the argument the
paper invokes).

``partition(g)`` returns the flat list of segments (each a list of node ids
in the original graph) such that segment k+1 sees segment k's cut node as a
*preplaced* boundary input.  ``partition_hierarchy(g)`` generalizes this to
a nested segment tree: each segment's induced subgraph is recursively
re-partitioned (with its boundary carried as preplaced input) until no
further separator splits its free nodes.  For single-node separator cuts the
flat pass is provably maximal — any separator of a segment's subgraph is
already a separator of the whole graph (DESIGN.md §8), so the recursion
converges after one level on chain-of-cells networks — but the tree is the
structure the scheduler walks and the isomorphic-cell plan reuse keys on:
stacked networks decompose into leaves whose anonymized subgraphs hash
identically, so each unique cell is DP-scheduled once and replayed.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.graph import Graph


@dataclasses.dataclass
class Segment:
    node_ids: list[int]          # nodes scheduled inside this segment
    boundary_in: list[int]       # preplaced producers from earlier segments


def find_separators(g: Graph) -> list[int]:
    n = len(g)
    anc = g.ancestors_masks()
    full = (1 << n) - 1
    desc = [0] * n
    for u in range(n):
        m = anc[u]  # mark u as a descendant of each of its ancestors
        for p in range(n):
            if m >> p & 1:
                desc[p] |= 1 << u
    seps = []
    topo = g.topo_order()
    for v in topo:
        cover = anc[v] | desc[v] | (1 << v)
        if cover != full:
            continue
        # (b) no ancestor->descendant edge bypassing v
        ok = True
        for b in range(n):
            if desc[v] >> b & 1:
                if g.pred_mask[b] & anc[v]:
                    ok = False
                    break
        if ok:
            seps.append(v)
    return seps


def partition(g: Graph) -> list[Segment]:
    """Split at every separator; segments are contiguous topo slices."""
    seps = find_separators(g)
    if not seps:
        return [Segment(node_ids=g.topo_order(), boundary_in=[])]
    anc = g.ancestors_masks()
    # order separators by ancestor-count (= topological position)
    seps.sort(key=lambda v: bin(anc[v]).count("1"))
    segments: list[Segment] = []
    placed = 0          # bitmask of nodes already assigned
    boundary: list[int] = []
    for v in seps:
        seg_mask = (anc[v] | (1 << v)) & ~placed
        ids = [u for u in range(len(g)) if seg_mask >> u & 1]
        if ids:
            segments.append(Segment(node_ids=ids, boundary_in=list(boundary)))
            placed |= seg_mask
            boundary = [v]
    rest = [u for u in range(len(g)) if not placed >> u & 1]
    if rest:
        segments.append(Segment(node_ids=rest, boundary_in=list(boundary)))
    return segments


# ---------------------------------------------------------------------------
# Nested segment tree (hierarchical divide and conquer, DESIGN.md §8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PartitionNode:
    """One node of the nested segment tree.

    ``node_ids`` are the original-graph nodes this (sub)segment schedules;
    ``boundary_in`` the preplaced producers from earlier segments.  Internal
    nodes delegate to ``children`` (in schedule order); leaves are the atomic
    cells the DP actually runs on.
    """

    node_ids: list[int]
    boundary_in: list[int]
    children: list["PartitionNode"] = dataclasses.field(default_factory=list)
    depth: int = 0

    def leaves(self) -> list["PartitionNode"]:
        if not self.children:
            return [self]
        out: list[PartitionNode] = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    @property
    def n_leaves(self) -> int:
        return len(self.leaves())

    @property
    def height(self) -> int:
        return 1 + max((c.height for c in self.children), default=0)


def partition_hierarchy(g: Graph, max_depth: int = 16) -> PartitionNode:
    """Nested segment tree: recursively split at single-node separators.

    Each level splits a segment's induced subgraph (boundary included as a
    regular node, so crossing edges stay visible to condition (b)) and
    recurses into every part that holds at least one free node; a part's
    boundary is the parent boundary plus any cut nodes placed before it.
    The recursion stops when the free nodes no longer split — for separator
    cuts that is depth one past the flat partition (the flat pass is
    maximal; see module docstring), but the guard keeps the construction
    correct even on graphs where a subgraph exposes structure the flat pass
    cannot.

    Concatenating per-leaf optimal schedules (boundary preplaced) is
    globally optimal by induction over the tree: every cut satisfies the
    separator conditions inside its parent's subgraph, and the parent's
    subgraph sees exactly the tensors the whole graph does at that cut.
    """

    def refine(node_ids: list[int], boundary_in: list[int],
               depth: int) -> PartitionNode:
        node = PartitionNode(node_ids=sorted(node_ids),
                             boundary_in=sorted(boundary_in), depth=depth)
        if depth >= max_depth or len(node_ids) <= 2:
            return node
        sub_ids = sorted(set(node_ids) | set(boundary_in))
        sub, idmap = g.induced_subgraph(sub_ids)
        inv = {v: k for k, v in idmap.items()}
        free = {idmap[u] for u in node_ids}
        parts = [s for s in partition(sub)
                 if any(u in free for u in s.node_ids)]
        if len(parts) < 2:
            return node          # no separator splits the free nodes: leaf
        for s in parts:
            child_ids = [inv[u] for u in s.node_ids if u in free]
            child_bnd = sorted(
                {inv[b] for b in s.boundary_in}
                | {inv[u] for u in s.node_ids if u not in free}
            )
            node.children.append(refine(child_ids, child_bnd, depth + 1))
        return node

    return refine(list(range(len(g))), [], 0)
