"""Identity graph rewriting (paper Section 3.3, Eq. 3-8, Fig. 9).

Two paper patterns plus one LM-era analogue (DESIGN.md §4):

* ``concat -> conv``        =>  accumulating *partial convs*  (channel-wise
  partitioning, Eq. 3-6).  Each branch input x_i is convolved with its channel
  slice of the kernel and accumulated in place into the output buffer, so the
  concatenated tensor never materializes:  cost  sum(x_i) + y  ->  max(x_i) + y.

* ``concat -> depthconv``   =>  *partial depthconvs* writing into their slice
  of the output (kernel-wise partitioning, Eq. 7-8).  The final ``concat_view``
  node aliases all partial outputs (slice-writes into one buffer, zero copy).

* ``fused_proj -> split``   =>  independent projections (distributive identity
  on the output-channel axis — the GeGLU/QKV analogue used on LM graphs).

All rewrites preserve mathematical identity; numeric equivalence of the conv
patterns is asserted against ``jax.lax`` convolutions in
``tests/test_rewriter_numeric.py``.

The rewriter is pure pattern matching over the IR: it returns a new Graph and
a report of the applied matches.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.graph import Graph, Node, simulate_schedule


@dataclasses.dataclass
class RewriteReport:
    n_concat_conv: int = 0
    n_concat_depthconv: int = 0
    n_fused_proj_split: int = 0
    n_inplace: int = 0            # set by annotate_inplace (separate pass)

    @property
    def total(self) -> int:
        return (self.n_concat_conv + self.n_concat_depthconv
                + self.n_fused_proj_split + self.n_inplace)


def _rebuild(specs: list[dict], name: str) -> Graph:
    return Graph.build(specs, name=name)


def rewrite_graph(g: Graph) -> tuple[Graph, RewriteReport]:
    """Apply all identity rewrites bottom-up until fixpoint (single pass is
    enough for the paper's patterns: matches never create new matches)."""
    report = RewriteReport()
    # Mutable spec list; node ids remapped at the end.
    specs: list[dict] = []
    for nd in g.nodes:
        specs.append(
            dict(
                name=nd.name,
                op=nd.op,
                size_bytes=nd.size_bytes,
                preds=list(nd.preds),
                alias_preds=set(nd.alias_preds),
                weight_bytes=nd.weight_bytes,
                meta=dict(nd.meta),
                dead=False,
            )
        )
    succs = [list(s) for s in g.succs]

    def single_consumer(i: int) -> int | None:
        alive = [s for s in succs[i] if not specs[s]["dead"]]
        return alive[0] if len(alive) == 1 else None

    next_id = len(specs)

    def add_node(spec: dict) -> int:
        nonlocal next_id
        spec.setdefault("alias_preds", set())
        spec.setdefault("weight_bytes", 0)
        spec.setdefault("meta", {})
        spec["dead"] = False
        specs.append(spec)
        succs.append([])
        for p in spec["preds"]:
            succs[p].append(next_id)
        i = next_id
        next_id += 1
        return i

    def redirect(old: int, new: int) -> None:
        """Point all consumers of `old` at `new`."""
        for s in list(succs[old]):
            if specs[s]["dead"]:
                continue
            specs[s]["preds"] = [new if p == old else p for p in specs[s]["preds"]]
            specs[s]["alias_preds"] = {
                new if p == old else p for p in specs[s]["alias_preds"]
            }
            succs[new].append(s)
        succs[old] = []

    for cid in range(len(g)):
        c = specs[cid]
        if c["dead"] or c["op"] != "concat" or len(c["preds"]) < 2:
            continue
        consumer = single_consumer(cid)
        if consumer is None:
            continue
        k = specs[consumer]
        if k["dead"] or k["preds"] != [cid]:
            continue   # conv must consume the concat alone
        branches = list(c["preds"])
        if k["op"] == "conv":
            # concat+conv  =>  accumulating partial convs (in-place into y).
            # Kernel of shape [m, sum(c_i), k, k] splits channel-wise; each
            # partial conv reads x_i and the running accumulator, writes the
            # accumulator in place (alias).  Weight bytes split evenly-ish by
            # branch activation share.
            total_in = sum(specs[b]["size_bytes"] for b in branches) or 1
            acc = None
            for j, b in enumerate(branches):
                w_share = k["weight_bytes"] * specs[b]["size_bytes"] // total_in
                preds = [b] if acc is None else [b, acc]
                alias = set() if acc is None else {acc}
                acc = add_node(
                    dict(
                        name=f"{k['name']}.partial{j}",
                        op="partial_conv",
                        size_bytes=k["size_bytes"],
                        preds=preds,
                        alias_preds=alias,
                        weight_bytes=w_share,
                        meta={**k["meta"], "rewritten_from": k["name"]},
                    )
                )
            specs[cid]["dead"] = True
            specs[consumer]["dead"] = True
            redirect(consumer, acc)
            report.n_concat_conv += 1
        elif k["op"] == "depthconv":
            # concat+depthconv  =>  per-branch depthconv + aliasing concat_view.
            total_in = sum(specs[b]["size_bytes"] for b in branches) or 1
            parts = []
            for j, b in enumerate(branches):
                share = k["size_bytes"] * specs[b]["size_bytes"] // total_in
                w_share = k["weight_bytes"] * specs[b]["size_bytes"] // total_in
                parts.append(
                    add_node(
                        dict(
                            name=f"{k['name']}.dw{j}",
                            op="partial_depthconv",
                            size_bytes=share,
                            preds=[b],
                            weight_bytes=w_share,
                            meta={**k["meta"], "rewritten_from": k["name"]},
                        )
                    )
                )
            view = add_node(
                dict(
                    name=f"{k['name']}.view",
                    op="concat_view",
                    size_bytes=k["size_bytes"],
                    preds=list(parts),
                    alias_preds=set(parts),
                    meta={"rewritten_from": k["name"]},
                )
            )
            specs[cid]["dead"] = True
            specs[consumer]["dead"] = True
            redirect(consumer, view)
            report.n_concat_depthconv += 1

    # fused_proj -> split : replace with independent per-output projections.
    for fid in range(len(g)):
        f = specs[fid]
        if f["dead"] or f["op"] != "fused_proj":
            continue
        consumer = single_consumer(fid)
        if consumer is None or specs[consumer]["op"] != "split":
            continue
        sp = specs[consumer]
        outs = [s for s in succs[consumer] if not specs[s]["dead"]]
        if not outs:
            continue
        total = sp["size_bytes"] or 1
        # one projection per downstream consumer of the split
        for j, o in enumerate(outs):
            share = f["size_bytes"] // len(outs)
            w_share = f["weight_bytes"] // len(outs)
            pj = add_node(
                dict(
                    name=f"{f['name']}.proj{j}",
                    op="proj",
                    size_bytes=share,
                    preds=list(f["preds"]),
                    weight_bytes=w_share,
                    meta={"rewritten_from": f["name"]},
                )
            )
            specs[o]["preds"] = [pj if p == consumer else p for p in specs[o]["preds"]]
            succs[pj].append(o)
        specs[fid]["dead"] = True
        specs[consumer]["dead"] = True
        report.n_fused_proj_split += 1

    # ---- compact: drop dead nodes, remap ids ---------------------------------
    alive = [i for i, s in enumerate(specs) if not s["dead"]]
    idmap = {old: new for new, old in enumerate(alive)}
    out_specs = []
    for old in alive:
        s = specs[old]
        out_specs.append(
            dict(
                name=s["name"],
                op=s["op"],
                size_bytes=s["size_bytes"],
                preds=[idmap[p] for p in s["preds"]],
                alias_preds={idmap[p] for p in s["alias_preds"]},
                weight_bytes=s["weight_bytes"],
                meta=s["meta"],
            )
        )
    return _rebuild(out_specs, name=f"{g.name}+rw"), report


# ---------------------------------------------------------------------------
# In-place elementwise annotation (DESIGN.md §4)
# ---------------------------------------------------------------------------

# Unary elementwise ops that can overwrite their input buffer: same element
# count in and out, each output element depends only on the matching input
# element.
INPLACE_UNARY_OPS = frozenset({
    "relu", "relu6", "bn", "batchnorm", "sigmoid", "tanh", "gelu", "silu",
    "bias_add", "scale", "dropout", "identity", "cast_inplace",
})
# N-ary accumulating ops: the output can be accumulated into one (dying)
# input buffer, like the rewriter's partial-conv accumulators.
INPLACE_ACCUM_OPS = frozenset({"add"})


def annotate_inplace(
    g: Graph,
    unary_ops: frozenset[str] = INPLACE_UNARY_OPS,
    accum_ops: frozenset[str] = INPLACE_ACCUM_OPS,
) -> tuple[Graph, int]:
    """Mark in-place-eligible elementwise ops as aliasing a predecessor.

    A predecessor ``p`` of node ``u`` is in-place-eligible when overwriting
    its buffer is safe and free:

      * ``u`` is its only consumer (nobody else reads ``p`` afterwards),
      * sizes match exactly (the output reuses the buffer verbatim),
      * ``p`` is not a graph input (caller-owned storage stays intact),
      * ``u`` does not already alias (rewriter chains take precedence).

    Unary ops alias their single predecessor; accumulating ops (``add``)
    alias one eligible operand.  The aliases flow through the existing
    alias-chain machinery: the DP charges zero net allocation for the node,
    the arena planner fuses the chain into one buffer, and the executor
    overwrites the predecessor's arena slice in place (DESIGN.md §6), so
    unary chains (relu -> bn -> ...) share storage end-to-end.

    Args:
      g: graph to annotate (node sizes in bytes; sizes must match exactly
        for a mark, since the output reuses the buffer verbatim).
      unary_ops: op names treated as unary elementwise (overwrite-safe).
      accum_ops: op names allowed to accumulate into one dying operand.

    Returns:
      ``(annotated_graph, n_marked)`` — the input graph object itself when
      nothing was marked (``n_marked == 0``), otherwise a rebuilt graph
      with ``alias_preds`` set on the marked nodes.
    """
    def eligible(u: Node, p: int) -> bool:
        return (
            len(g.succs[p]) == 1
            and g.sizes[p] == u.size_bytes
            and g.nodes[p].op != "input"
        )

    n_marked = 0
    specs: list[dict] = []
    for nd in g.nodes:
        alias = set(nd.alias_preds)
        if not alias:
            if nd.op in unary_ops and len(nd.preds) == 1:
                if eligible(nd, nd.preds[0]):
                    alias = {nd.preds[0]}
                    n_marked += 1
            elif nd.op in accum_ops and len(nd.preds) >= 2:
                # alias at most one operand; preds may repeat, and a
                # duplicated operand has >= 2 uses here, so require a
                # uniquely-consumed single occurrence
                for p in nd.preds:
                    if nd.preds.count(p) == 1 and eligible(nd, p):
                        alias = {p}
                        n_marked += 1
                        break
        specs.append(
            dict(
                name=nd.name,
                op=nd.op,
                size_bytes=nd.size_bytes,
                preds=list(nd.preds),
                alias_preds=alias,
                weight_bytes=nd.weight_bytes,
                meta=dict(nd.meta),
            )
        )
    if n_marked == 0:
        return g, 0
    return _rebuild(specs, name=g.name), n_marked


# ---------------------------------------------------------------------------
# Rematerialization: trade FLOPs for peak (DESIGN.md §10)
# ---------------------------------------------------------------------------

# Ops a recompute clone may never replicate: inputs are caller-owned storage,
# and the rewriter's alias-chain ops (accumulators, views) reuse their
# predecessors' buffers — a clone would need its own alias chain and the
# single-consumer alias invariant forbids it anyway.
RECOMPUTE_EXCLUDED_OPS = frozenset({
    "input", "concat_view", "partial_conv", "partial_depthconv",
})


def _spec_flops(spec: dict, size_of) -> int:
    """Surrogate FLOPs of one node spec (``size_of(id) -> bytes``).

    Weightless ops (elementwise, views, adds, concats) cost one op per
    output element.  For weighted ops the true MAC count is estimated as
    the geometric mean ``sqrt(weights * in_elems * out_elems)`` — exact
    for 1x1 convolutions (``px*cin*cout``) and within a small constant
    factor for kxk/depthwise kernels (DESIGN.md §10).  Units are abstract
    "surrogate FLOPs"; only ratios of them are ever consumed.
    """
    out = max(spec["size_bytes"] // 4, 1)
    w = spec.get("weight_bytes", 0) // 4
    if w <= 0:
        return out
    ins = max(sum(size_of(p) for p in spec["preds"]) // 4, 1)
    return max(out, math.isqrt(w * ins * out))


def node_flops(g: Graph, u: int) -> int:
    """Surrogate FLOPs of node ``u`` (see :func:`graph_flops`)."""
    nd = g.nodes[u]
    if nd.op == "input":
        return 0
    spec = dict(size_bytes=nd.size_bytes, weight_bytes=nd.weight_bytes,
                preds=nd.preds)
    return _spec_flops(spec, lambda p: g.sizes[p])


def graph_flops(g: Graph) -> int:
    """Total surrogate FLOPs of ``g`` (inputs cost nothing)."""
    return sum(node_flops(g, u) for u in range(len(g)))


@dataclasses.dataclass
class RecomputeReport:
    """What :func:`rematerialize` did to a graph.

    ``frontier`` is the peak-vs-FLOPs Pareto frontier over every clone set
    the beam search evaluated: ``(flops_ratio, peak_bytes, n_clones)``
    tuples sorted by ratio, starting at the no-recompute base point
    ``(1.0, base_peak, 0)`` and strictly decreasing in peak.  Peaks are
    bounded-search upper bounds (any frontier point is achievable by a
    real schedule; the true optimum of that clone set can only be lower).
    """

    n_steps: int = 0                 # beam steps applied on the chosen path
    n_clones: int = 0                # recompute nodes emitted
    extra_flops: int = 0             # surrogate FLOPs added by the clones
    base_flops: int = 0              # surrogate FLOPs of the input graph
    base_peak_bytes: int = 0         # bounded-search peak of the base graph
    peak_bytes: int = 0              # bounded-search peak of the chosen graph
    n_evals: int = 0                 # clone sets evaluated by the search
    cloned: list[str] = dataclasses.field(default_factory=list)
    frontier: tuple[tuple[float, int, int], ...] = ()

    @property
    def flops_ratio(self) -> float:
        """Expanded-graph FLOPs as a multiple of the base graph's."""
        if self.base_flops <= 0:
            return 1.0
        return (self.base_flops + self.extra_flops) / self.base_flops


def recompute_provenance(nd: Node) -> tuple[str, int] | None:
    """``(original name, original id)`` when ``nd`` is a recompute clone."""
    meta = dict(nd.meta)
    if "recompute_of" not in meta:
        return None
    return str(meta["recompute_of"]), int(meta["recompute_sig"])


def _clone_out(g: Graph, u: int, n_clone: int) -> Graph:
    """One rematerialization step: clone ``u`` for its last ``n_clone``
    consumers (by node id — a proxy for topological position).

    Each clone is a fresh node with the same op/size/weights reading the
    same predecessors; its consumer's pred edge is rewired onto it.  After
    the step ``u``'s output dies at its earliest remaining consumer instead
    of staying live across all of them.  Clones append at the end, so every
    original node keeps its id — provenance ids stay valid and the step
    composes (a clone, having one consumer, is itself never a candidate,
    but cloning ``u`` makes ``u``'s predecessors multi-consumer, which is
    how chains unroll back to an anchor over successive steps).
    """
    specs: list[dict] = []
    for nd in g.nodes:
        specs.append(
            dict(
                name=nd.name,
                op=nd.op,
                size_bytes=nd.size_bytes,
                preds=list(nd.preds),
                alias_preds=set(nd.alias_preds),
                weight_bytes=nd.weight_bytes,
                meta=dict(nd.meta),
            )
        )
    cons = sorted(g.succs[u])
    root = specs[u]["meta"].get("recompute_of", specs[u]["name"])
    sig = specs[u]["meta"].get("recompute_sig", u)
    for c in cons[len(cons) - n_clone:]:
        ci = len(specs)
        specs.append(
            dict(
                name=f"{root}.rc{ci}",
                op=specs[u]["op"],
                size_bytes=specs[u]["size_bytes"],
                preds=list(specs[u]["preds"]),
                alias_preds=set(),
                weight_bytes=specs[u]["weight_bytes"],
                meta={**specs[u]["meta"],
                      "recompute_of": root, "recompute_sig": sig},
            )
        )
        specs[c]["preds"] = [ci if p == u else p for p in specs[c]["preds"]]
    return _rebuild(specs, name=g.name)


def rematerialize(
    g: Graph,
    *,
    flops_budget: float = 1.3,
    beam_width: int = 4,
    max_rounds: int = 6,
    eval_quota: int = 800,
    inplace: bool = True,
) -> tuple[Graph, RecomputeReport]:
    """Expand ``g`` with recompute clones that lower its schedulable peak.

    The planner-side half of rematerialization.  A *step* picks a
    multi-consumer node and gives some of its consumers their own clone —
    a fresh node with the same op/size/weights reading the same
    predecessors — so the original's output dies early instead of staying
    live across all consumers.  The scheduler needs no new machinery: it
    simply orders the expanded DAG (each clone right before its consumer,
    if that is where the optimum lies).

    Which steps actually help is decided *empirically*, not by a static
    score: a small beam search applies candidate steps and evaluates each
    resulting graph with a bounded beam DP
    (:func:`~repro_torch.core.scheduler.dp_schedule` with ``on_quota='beam'``),
    keeping the ``beam_width`` lowest-peak states per round.  Scheduler
    feedback is essential — a clone can *raise* the exact peak (it extends
    its predecessors' liveness and can break in-place eligibility), which
    no liveness heuristic reliably predicts.  Because every evaluation is
    a real schedule, each frontier point is an achievable upper bound.

    Clones carry provenance metadata — ``recompute_of`` (the root original
    node's name) and ``recompute_sig`` (its id in the pre-expansion
    graph) — which the executor uses to give a clone the *same* surrogate
    value function as its original, so expanded-graph outputs stay
    bit-equal to the no-recompute reference.

    Args:
      g: graph to expand (typically post-``rewrite_graph``, pre-
        ``annotate_inplace`` — cloning changes consumer counts and hence
        in-place eligibility, so the in-place pass must rerun after).
      flops_budget: cap on expanded/base surrogate-FLOPs ratio (≥ 1.0);
        the search never applies a step that would exceed it.
      beam_width: states kept per beam round.
      max_rounds: beam rounds (clone steps on the deepest path).
      eval_quota: DP state quota per evaluation; higher is tighter but
        slower.  Evaluation cost is roughly
        ``beam_width * candidates * max_rounds`` bounded-DP runs.
      inplace: evaluate candidate graphs with in-place annotation applied
        (must match how the final graph will be scheduled).

    Returns:
      ``(expanded graph, RecomputeReport)`` — the input graph object
      itself when no clone set within budget lowers the evaluated peak.
      The report's ``frontier`` has the full peak-vs-FLOPs Pareto
      frontier; the returned graph is the frontier's lowest-peak point.
    """
    from repro_torch.core.scheduler import dp_schedule

    base_flops = graph_flops(g)

    def _peak(gx: Graph) -> int:
        gi = annotate_inplace(gx)[0] if inplace else gx
        res = dp_schedule(gi, state_quota=eval_quota, on_quota="beam")
        return simulate_schedule(gi, res.order).peak_bytes

    def _key(gx: Graph) -> tuple:
        # A clone set's identity: which original node each clone recomputes
        # and which consumers it feeds — invariant to discovery order.
        ks = []
        for i in range(len(g.nodes), len(gx.nodes)):
            sig = dict(gx.nodes[i].meta)["recompute_sig"]
            ks.append((sig, tuple(sorted(gx.succs[i]))))
        return tuple(sorted(ks))

    report = RecomputeReport(base_flops=base_flops)
    base_peak = _peak(g)
    report.base_peak_bytes = base_peak
    report.n_evals = 1

    # beam state: (eval peak, extra flops, steps applied, graph)
    beam: list[tuple[int, int, int, Graph]] = [(base_peak, 0, 0, g)]
    evaluated = list(beam)
    seen = {_key(g)}
    for _round in range(max_rounds):
        grown: list[tuple[int, int, int, Graph]] = []
        for _, extra, steps, bg in beam:
            for u in range(len(bg.nodes)):
                nd = bg.nodes[u]
                n_cons = len(bg.succs[u])
                if (n_cons < 2 or nd.op in RECOMPUTE_EXCLUDED_OPS
                        or nd.alias_preds):
                    continue
                fl = node_flops(bg, u)
                # two step shapes: peel the single farthest consumer, or
                # clone out all but the first — intermediate splits are
                # reachable by composing peels across rounds
                for n_clone in {1, n_cons - 1}:
                    extra2 = extra + fl * n_clone
                    if (base_flops + extra2) / base_flops > flops_budget:
                        continue
                    gx = _clone_out(bg, u, n_clone)
                    k = _key(gx)
                    if k in seen:
                        continue
                    seen.add(k)
                    report.n_evals += 1
                    grown.append((_peak(gx), extra2, steps + 1, gx))
        if not grown:
            break
        grown.sort(key=lambda s: (s[0], s[1]))
        beam = grown[:beam_width]
        evaluated.extend(beam)

    # Pareto frontier over evaluated states: sort by FLOPs, keep strictly
    # decreasing peaks.  The base point always leads, so a state only
    # appears if it beats the no-recompute peak.
    evaluated.sort(key=lambda s: (s[1], s[0]))
    frontier: list[tuple[float, int, int]] = []
    best_peak = None
    winner: tuple[int, int, int, Graph] | None = None
    for st in evaluated:
        if best_peak is not None and st[0] >= best_peak:
            continue
        best_peak = st[0]
        ratio = (base_flops + st[1]) / base_flops if base_flops else 1.0
        frontier.append((ratio, st[0], len(st[3].nodes) - len(g.nodes)))
        winner = st
    report.frontier = tuple(frontier)

    if winner is None or winner[3] is g:
        report.peak_bytes = base_peak
        return g, report
    peak, extra, steps, gw = winner
    report.peak_bytes = peak
    report.extra_flops = extra
    report.n_steps = steps
    report.n_clones = len(gw.nodes) - len(g.nodes)
    report.cloned = sorted(
        {recompute_provenance(nd)[0]
         for nd in gw.nodes[len(g.nodes):]})
    gw = _rebuild(
        [dict(name=nd.name, op=nd.op, size_bytes=nd.size_bytes,
              preds=list(nd.preds), alias_preds=set(nd.alias_preds),
              weight_bytes=nd.weight_bytes, meta=dict(nd.meta))
         for nd in gw.nodes],
        name=f"{g.name}+rc{report.n_clones}")
    return gw, report


# ---------------------------------------------------------------------------
# Alias-chain fusion regions (DESIGN.md §11)
# ---------------------------------------------------------------------------

# Ops that never join a fused region.  A ``concat_view`` computes nothing —
# its parts already sit back-to-back at distinct intra-buffer offsets — so
# there is no value to forward through it, and its members' writes land at
# different addresses than the view's own offset.
FUSE_BARRIER_OPS = frozenset({"concat_view"})


@dataclasses.dataclass(frozen=True)
class FusedRegion:
    """A maximal schedule-contiguous in-place alias chain, executed as one
    unit: the head's value is computed once, every member transforms it in
    registers, and the final value is written to the chain's (shared) arena
    slice in a single store (DESIGN.md §11).

    ``node_ids`` is ordered as scheduled; a length-1 region is an unfused
    node (the slice-per-node step).
    """

    node_ids: tuple[int, ...]

    @property
    def head(self) -> int:
        return self.node_ids[0]

    @property
    def out(self) -> int:
        """The node whose value the region's single write stores."""
        return self.node_ids[-1]

    def __len__(self) -> int:
        return len(self.node_ids)


def fuse_alias_chains(g: Graph, order, plan=None) -> list[FusedRegion]:
    """Partition a schedule into maximal in-place alias chains.

    A *link* ``u -> v`` exists when ``v`` aliases exactly ``u``
    (``alias_preds == {u}`` — the chains produced by
    :func:`annotate_inplace` and the rewriter's accumulating partial
    convs), neither op is a fusion barrier, sizes match exactly, and —
    when a ``plan`` is given — both nodes resolve to the *same* planned
    byte offset (an intra-buffer delta would mean the running value no
    longer stands for the arena content at the write address).  Since an
    aliased predecessor has exactly one consumer (``Graph`` validation),
    links form vertex-disjoint paths; each maximal path is one
    :class:`FusedRegion`, every other node a singleton.

    Members need *not* be schedule-contiguous: the DP routinely interleaves
    branch computation between a chain's accumulation steps.  Fused
    execution is still legal because nothing outside the chain can read an
    interior member (single-consumer invariant) and the chain's allocation
    stays live for the chain's whole span, so no interleaved node writes
    into its slice.  The executor therefore forwards the running value in
    registers across the gaps and stores only the final member
    (DESIGN.md §11).

    Returns regions covering ``order`` exactly once, ordered by head
    schedule position, with each region's ``node_ids`` in schedule order.
    """
    order = list(order)
    pos = {u: i for i, u in enumerate(order)}
    link: dict[int, int] = {}
    for v in order:
        nd = g.nodes[v]
        if len(nd.alias_preds) != 1 or nd.op in FUSE_BARRIER_OPS:
            continue
        (u,) = tuple(nd.alias_preds)
        if (u in pos
                and g.nodes[u].op not in FUSE_BARRIER_OPS
                and g.sizes[v] == g.sizes[u]
                and (plan is None
                     or plan.offset_of(v) == plan.offset_of(u))):
            link[u] = v
    tails = set(link.values())
    regions: list[FusedRegion] = []
    for u in order:                      # heads precede members in order
        if u in tails:
            continue
        chain = [u]
        while chain[-1] in link:
            chain.append(link[chain[-1]])
        regions.append(FusedRegion(tuple(chain)))
    return regions
