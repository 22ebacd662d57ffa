"""Dataflow-graph intermediate representation for SERENITY scheduling.

The IR mirrors the paper's augmented graph (Section 3): every node carries
operation type, input/output edges, output shape and memory cost.  The memory
model is exactly Algorithm 1's:

  * scheduling node ``u`` allocates ``u.size_bytes`` (its output activation),
  * the running footprint ``mu`` is bumped, the peak ``mu_peak`` updated,
  * any predecessor whose consumers are now all scheduled is deallocated.

Two extensions (documented in DESIGN.md §3) generalize the model without
changing it on paper graphs:

  * ``alias_preds`` — in-place/viewing ops (the rewriter's accumulating
    partial-conv and slice-writing concat) whose output storage subsumes the
    listed predecessors' storage.  Scheduling such a node adds
    ``size - sum(aliased sizes)`` bytes and the aliased predecessors are never
    separately freed (their storage lives on inside the node's output).
  * ``preplaced`` nodes — used by divide-and-conquer: boundary tensors that are
    already resident when a sub-schedule starts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Node:
    """One operation in the dataflow graph."""

    id: int
    name: str
    op: str
    size_bytes: int                      # bytes of the node's output activation
    preds: tuple[int, ...] = ()
    alias_preds: frozenset[int] = frozenset()
    weight_bytes: int = 0                # parameter bytes read by this op (traffic model)
    meta: tuple[tuple[str, object], ...] = ()

    def replace(self, **kw) -> "Node":
        return dataclasses.replace(self, **kw)


class GraphError(ValueError):
    pass


class Graph:
    """An immutable DAG of :class:`Node` with O(1) pred/succ lookups.

    Node ids must be dense ``0..n-1``.  Edges are implied by ``node.preds``.
    """

    def __init__(self, nodes: Sequence[Node], name: str = "graph"):
        nodes = sorted(nodes, key=lambda n: n.id)
        if [n.id for n in nodes] != list(range(len(nodes))):
            raise GraphError("node ids must be dense 0..n-1")
        self.name = name
        self.nodes: tuple[Node, ...] = tuple(nodes)
        n = len(nodes)
        succs: list[list[int]] = [[] for _ in range(n)]
        for nd in nodes:
            for p in nd.preds:
                if not (0 <= p < n):
                    raise GraphError(f"node {nd.id} has out-of-range pred {p}")
                if p == nd.id:
                    raise GraphError(f"self-loop at node {nd.id}")
                succs[p].append(nd.id)
        self.succs: tuple[tuple[int, ...], ...] = tuple(tuple(s) for s in succs)
        self.sizes: tuple[int, ...] = tuple(nd.size_bytes for nd in nodes)
        # Bitmask helpers for the DP scheduler.
        self.pred_mask: tuple[int, ...] = tuple(
            _mask(nd.preds) for nd in nodes
        )
        self.succ_mask: tuple[int, ...] = tuple(_mask(s) for s in self.succs)
        self._validate()

    # -- construction helpers ------------------------------------------------

    @staticmethod
    def build(specs: Iterable[Mapping], name: str = "graph") -> "Graph":
        """Build from dicts with keys name/op/size_bytes/preds[/alias_preds]."""
        nodes = []
        for i, s in enumerate(specs):
            nodes.append(
                Node(
                    id=i,
                    name=s.get("name", f"n{i}"),
                    op=s.get("op", "op"),
                    size_bytes=int(s["size_bytes"]),
                    preds=tuple(s.get("preds", ())),
                    alias_preds=frozenset(s.get("alias_preds", ())),
                    weight_bytes=int(s.get("weight_bytes", 0)),
                    meta=tuple(sorted(dict(s.get("meta", {})).items())),
                )
            )
        return Graph(nodes, name=name)

    # -- basic queries ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.nodes)

    @property
    def n_edges(self) -> int:
        return sum(len(nd.preds) for nd in self.nodes)

    def entries(self) -> tuple[int, ...]:
        return tuple(nd.id for nd in self.nodes if not nd.preds)

    def exits(self) -> tuple[int, ...]:
        return tuple(nd.id for nd in self.nodes if not self.succs[nd.id])

    def total_bytes(self) -> int:
        return sum(self.sizes)

    def topo_order(self) -> list[int]:
        """Kahn order with FIFO tie-break on node id (deterministic)."""
        from collections import deque

        indeg = [len(nd.preds) for nd in self.nodes]
        q = deque(i for i in range(len(self)) if indeg[i] == 0)
        order: list[int] = []
        while q:
            u = q.popleft()
            order.append(u)
            for v in self.succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    q.append(v)
        if len(order) != len(self):
            raise GraphError("graph has a cycle")
        return order

    def is_topological(self, order: Sequence[int]) -> bool:
        pos = {u: i for i, u in enumerate(order)}
        if len(pos) != len(self):
            return False
        return all(pos[p] < pos[nd.id] for nd in self.nodes for p in nd.preds)

    # -- structure -------------------------------------------------------------

    def ancestors_masks(self) -> list[int]:
        """Bitmask of strict ancestors per node (O(V·E/64) via topo DP)."""
        anc = [0] * len(self)
        for u in self.topo_order():
            m = 0
            for p in self.nodes[u].preds:
                m |= anc[p] | (1 << p)
            anc[u] = m
        return anc

    def descendants_masks(self) -> list[int]:
        """Bitmask of strict descendants per node (transpose of ancestors)."""
        anc = self.ancestors_masks()
        desc = [0] * len(self)
        for u in range(len(self)):
            m = anc[u]
            while m:
                b = m & -m
                m ^= b
                desc[b.bit_length() - 1] |= 1 << u
        return desc

    def induced_subgraph(
        self, node_ids: Sequence[int], anonymize: bool = False
    ) -> tuple["Graph", dict[int, int]]:
        """Subgraph on ``node_ids``; edges from outside are dropped.

        ``anonymize`` replaces node names with ``n{new_id}`` and drops
        ``meta`` (which carries provenance labels such as the rewriter's
        ``rewritten_from``) so that two structurally identical segments
        whose nodes merely carry different labels (stacked cells: ``c0.x``
        vs ``c3.x``) produce byte-identical graphs.  The scheduler reads
        only op/sizes/wiring/alias, so this is exactly the payload the
        isomorphic-cell plan reuse may key on (DESIGN.md §8).

        Returns (subgraph, old_id -> new_id map).
        """
        idmap = {old: new for new, old in enumerate(sorted(node_ids))}
        nodes = []
        for old in sorted(node_ids):
            nd = self.nodes[old]
            preds = tuple(idmap[p] for p in nd.preds if p in idmap)
            alias = frozenset(idmap[p] for p in nd.alias_preds if p in idmap)
            nodes.append(
                Node(
                    id=idmap[old],
                    name=f"n{idmap[old]}" if anonymize else nd.name,
                    op=nd.op,
                    size_bytes=nd.size_bytes,
                    preds=preds,
                    alias_preds=alias,
                    weight_bytes=nd.weight_bytes,
                    meta=() if anonymize else nd.meta,
                )
            )
        return Graph(nodes, name=f"{self.name}.sub"), idmap

    # -- validation ------------------------------------------------------------

    def _validate(self) -> None:
        self.topo_order()  # raises on cycles
        for nd in self.nodes:
            if nd.size_bytes < 0:
                raise GraphError(f"negative size at node {nd.id}")
            extra = nd.alias_preds - set(nd.preds)
            if extra:
                raise GraphError(f"alias_preds {extra} of node {nd.id} not preds")
            for p in nd.alias_preds:
                if len(self.succs[p]) != 1:
                    raise GraphError(
                        f"node {nd.id} aliases pred {p} which has "
                        f"{len(self.succs[p])} consumers (must be 1)"
                    )

    # -- vectorized scheduling tables ------------------------------------------

    def masks(self) -> "BitmaskTables":
        """Numpy bitmask/byte tables for the vectorized DP (built once, cached)."""
        bt = self.__dict__.get("_masks")
        if bt is None:
            bt = BitmaskTables(self)
            self._masks = bt
        return bt

    def __getstate__(self) -> dict:
        # derived tables are pure caches — rebuild on demand after unpickle
        # rather than bloating every pickled plan (the bound tables alone
        # hold an O(n^2) float64 matrix)
        state = dict(self.__dict__)
        for cache_attr in ("_masks", "_bound_tables", "_incumbents"):
            state.pop(cache_attr, None)
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)

    def __repr__(self) -> str:
        return (
            f"Graph({self.name!r}, nodes={len(self)}, edges={self.n_edges}, "
            f"bytes={self.total_bytes()})"
        )


def _mask(ids: Iterable[int]) -> int:
    m = 0
    for i in ids:
        m |= 1 << i
    return m


class BitmaskTables:
    """Per-graph numpy tables backing the vectorized bitmask DP.

    Masks over the ``n`` nodes are packed into ``words = ceil(n/64)`` little-
    endian uint64 words, so a level of ``S`` DP states is an ``(S, words)``
    array and every transition rule (alloc, dealloc, frontier update) becomes
    a batched integer operation instead of a per-state Python loop.

    For single-word graphs (``n <= 64`` — every paper cell) the scheduler uses
    the dense ``(n, n)`` helper matrices to evaluate *all* transitions of a
    level in a handful of numpy ops.
    """

    def __init__(self, g: "Graph"):
        n = len(g)
        self.n = n
        self.words = W = max(1, (n + 63) // 64)
        self.sizes = np.array(g.sizes, dtype=np.int64)
        self.pred_mask = _pack_masks(g.pred_mask, W)          # (n, W) uint64
        self.succ_mask = _pack_masks(g.succ_mask, W)          # (n, W) uint64
        self.node_bit = _pack_masks([1 << i for i in range(n)], W)
        # net bytes allocated when scheduling u (aliased storage subsumed)
        self.net_alloc = np.array(
            [g.sizes[u] - sum(g.sizes[p] for p in g.nodes[u].alias_preds)
             for u in range(n)],
            dtype=np.int64,
        )
        # bytes the arena must find room for (aliases reuse their pred's
        # storage, so never less than zero) — the DP's watermark estimate
        self.alloc_pos = np.maximum(self.net_alloc, 0)
        # Two CSR edge tables sharing one subset test: scheduling u touches
        # its non-alias preds (freed iff the pred's successor mask is now a
        # subset of the signature; contributes `size` bytes) and its succs
        # (enter the frontier iff their pred mask is a subset; contribute a
        # frontier `bit`).  They are kept separate because the DP needs the
        # freed bytes for *every* transition of a level (the eager-move
        # dominance test, DESIGN.md §8) but the frontier refill only for the
        # deduplicated winners; each table is expanded with a single
        # repeat/gather/reduceat pass per level.
        pe_tgt: list[int] = []       # pred edges: succ mask to be covered
        pe_size: list[int] = []      # bytes freed on hit
        pe_len = np.zeros(n, dtype=np.int64)
        se_tgt: list[int] = []       # succ edges: pred mask to be covered
        se_bit: list[int] = []       # frontier bit set on hit
        se_len = np.zeros(n, dtype=np.int64)
        for u in range(n):
            nd = g.nodes[u]
            for p in nd.preds:
                if p not in nd.alias_preds:
                    pe_tgt.append(g.succ_mask[p])
                    pe_size.append(g.sizes[p])
                    pe_len[u] += 1
            for s in g.succs[u]:
                se_tgt.append(g.pred_mask[s])
                se_bit.append(1 << s)
                se_len[u] += 1
        self.pe_tgt = _pack_masks(pe_tgt, W)
        self.pe_size = np.array(pe_size, dtype=np.int64)
        self.pe_len = pe_len
        self.pe_off = np.concatenate(([0], np.cumsum(pe_len)))[:-1]
        self.se_tgt = _pack_masks(se_tgt, W)
        self.se_bit = _pack_masks(se_bit, W)
        self.se_len = se_len
        self.se_off = np.concatenate(([0], np.cumsum(se_len)))[:-1]
        if W == 1:
            self.pred_mask1 = self.pred_mask[:, 0]
            self.succ_mask1 = self.succ_mask[:, 0]
            self.node_bit1 = self.node_bit[:, 0]
            self.pe_tgt1 = self.pe_tgt[:, 0]
            self.se_tgt1 = self.se_tgt[:, 0]
            self.se_bit1 = self.se_bit[:, 0]


def _pack_masks(masks: Sequence[int], words: int) -> np.ndarray:
    out = np.zeros((len(masks), words), dtype=np.uint64)
    for i, m in enumerate(masks):
        for w in range(words):
            out[i, w] = (m >> (64 * w)) & 0xFFFFFFFFFFFFFFFF
    return out


# ---------------------------------------------------------------------------
# Memory simulation (the single source of truth for the footprint model).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    peak_bytes: int
    trace: list[int]          # footprint after each scheduled node (incl. deallocs)
    final_bytes: int


def simulate_schedule(
    g: Graph,
    order: Sequence[int],
    preplaced: Sequence[int] = (),
    keep_outputs: bool = True,
) -> SimResult:
    """Replay ``order`` through the paper's alloc/dealloc model.

    ``preplaced`` nodes start resident (their bytes count toward mu_0) and are
    freed after their last in-schedule consumer, like any other tensor.
    ``keep_outputs``: tensors with no consumers stay resident to the end
    (graph outputs must survive), matching the paper's trace in Fig. 12(b).
    """
    n = len(g)
    pre = set(preplaced)
    sched_set = set(order)
    if sched_set & pre:
        raise GraphError("schedule and preplaced overlap")
    # remaining consumers *within this schedule* for every producer
    remaining = [0] * n
    for u in order:
        for p in g.nodes[u].preds:
            remaining[p] += 1
    resident = [False] * n
    mu = 0
    for p in pre:
        resident[p] = True
        mu += g.sizes[p]
    peak = mu
    trace: list[int] = []
    for u in order:
        nd = g.nodes[u]
        for p in nd.preds:
            if not resident[p]:
                raise GraphError(
                    f"schedule not topological: node {u} needs {p} "
                    f"which is not resident"
                )
        alias_bytes = sum(g.sizes[p] for p in nd.alias_preds)
        mu += g.sizes[u] - alias_bytes
        resident[u] = True
        peak = max(peak, mu)
        for p in nd.preds:
            remaining[p] -= 1
            if remaining[p] == 0 and resident[p]:
                resident[p] = False
                if p not in nd.alias_preds:   # aliased storage lives on inside u
                    mu -= g.sizes[p]
        trace.append(mu)
    del keep_outputs  # outputs (no consumers) are never freed by construction
    return SimResult(peak_bytes=peak, trace=trace, final_bytes=mu)


def simulate_steps(
    g: Graph,
    steps: Sequence[Sequence[int]],
    preplaced: Sequence[int] = (),
) -> SimResult:
    """Replay a width-W *step schedule* through the concurrent-step model.

    A step issues its member ops concurrently (DESIGN.md §12): every
    member's output storage is claimed *before* any of the step's
    deallocations land, so the step's transient is

        mu_before + sum over members of max(net_alloc, 0)

    (an alias member only claims the bytes its output needs beyond its
    pred's storage — exactly the allocator's ``alloc_pos``), and
    predecessors fully consumed by the step are freed at the step's end.
    Members of one step must be mutually independent (no intra-step edge);
    a step reading a value produced in the same step is rejected.

    With every step a singleton this reproduces :func:`simulate_schedule`
    bit-for-bit (same peak, same per-step trace, same final bytes): a
    negative-net alias op claims 0 transient bytes here versus a negative
    delta there, but ``mu`` never exceeds the running peak between ops, so
    the max is unaffected.

    ``trace`` holds the footprint after each *step* (including its frees).
    """
    n = len(g)
    pre = set(preplaced)
    flat = [u for step in steps for u in step]
    if len(set(flat)) != len(flat):
        raise GraphError("step schedule repeats a node")
    if set(flat) & pre:
        raise GraphError("schedule and preplaced overlap")
    remaining = [0] * n
    for u in flat:
        for p in g.nodes[u].preds:
            remaining[p] += 1
    resident = [False] * n
    mu = 0
    for p in pre:
        resident[p] = True
        mu += g.sizes[p]
    peak = mu
    trace: list[int] = []
    for step in steps:
        in_step = set(step)
        claimed = 0
        net = 0
        for u in step:
            nd = g.nodes[u]
            for p in nd.preds:
                if p in in_step:
                    raise GraphError(
                        f"step {tuple(step)} is not an antichain: node {u} "
                        f"reads co-issued node {p}")
                if not resident[p]:
                    raise GraphError(
                        f"schedule not topological: node {u} needs {p} "
                        f"which is not resident")
            alias_bytes = sum(g.sizes[p] for p in nd.alias_preds)
            claimed += max(g.sizes[u] - alias_bytes, 0)
            net += g.sizes[u] - alias_bytes
        peak = max(peak, mu + claimed)
        mu += net
        for u in step:
            resident[u] = True
        for u in step:
            nd = g.nodes[u]
            for p in nd.preds:
                remaining[p] -= 1
                if remaining[p] == 0 and resident[p]:
                    resident[p] = False
                    if p not in nd.alias_preds:
                        mu -= g.sizes[p]
        trace.append(mu)
    return SimResult(peak_bytes=peak, trace=trace, final_bytes=mu)


def graph_to_specs(g) -> list[dict]:
    """The spec list :meth:`Graph.build` takes, read back from ``g``.

    ``g`` may be a graph of this package or of any package whose nodes carry
    the same fields (the JAX package's does), so a test can build the same
    graph in both from one list: ``Graph.build(graph_to_specs(g), g.name)``.
    """
    return [dict(name=nd.name, op=nd.op, size_bytes=nd.size_bytes,
                 preds=list(nd.preds), alias_preds=sorted(nd.alias_preds),
                 weight_bytes=nd.weight_bytes, meta=dict(nd.meta))
            for nd in g.nodes]
