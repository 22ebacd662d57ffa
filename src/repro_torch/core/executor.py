"""Arena-backed execution of SERENITY schedules on PyTorch (DESIGN.md §6).

The scheduler/allocator stack plans *where* every intermediate tensor lives
(`ScheduleResult.order` + `ArenaPlan` byte offsets); this module runs a
graph against that plan: one linear float32 arena tensor holds every
intermediate, each node reads its predecessors as slices at their planned
offsets and writes its output at its own offset
(``repro_torch.kernels.arena``: hand-written CUDA kernels for tensors on the
card, their plain PyTorch versions for tensors on the CPU).  The arena is
updated in place.  Alias chains from the rewriter execute without copies:
in-place nodes overwrite their predecessor's slice, ``concat_view`` parts
slice-write back-to-back into the view's buffer, so the rewritten concat is
never materialized.

Because benchmark graphs carry only byte costs (not tensor semantics), node
computation uses a *surrogate numerics* registry: every tensor is a flat
float32 vector of ``size_bytes / 4`` elements and every op is a
deterministic, value- and position-sensitive function of its inputs (the
same functions as the JAX package's executor).  The executor's correctness
contract is *schedule/arena transparency*: for any graph and any valid
(order, plan), ``execute_plan`` produces bit-for-bit the values of the plain
dict-storage interpreter ``run_reference`` on the same device.

Alongside values, execution *measures* the arena (realized, not estimated):

  ``realized_peak_bytes``  -- high-water of live bytes resident in the arena,
                              tracked from executed alloc/free events; must
                              equal ``ArenaPlan.peak_bytes`` exactly.
  ``realized_arena_bytes`` -- high-water byte extent (max live offset+size);
                              must equal ``ArenaPlan.arena_bytes`` exactly.

``strict=True`` (default) asserts both equalities.

Execution has two granularities (DESIGN.md §11): the default
*slice-per-node* path issues one arena read per predecessor and one write
per node, and the *fused* path (``fuse=True``) executes each in-place alias
chain (:func:`repro_torch.core.rewriter.fuse_alias_chains`) as one region:
the running value is forwarded between chain members and the chain's shared
slice is written once (one chain-kernel launch for pure-elementwise tails).

Entry points run on the card unless the caller passes ``device='cpu'``:
``device=None`` means ``'cuda'``, and raises when CUDA is absent.

Public entry points
-------------------
run_reference(g, inputs)                   -> {output name: value}
reference_fn(g)                            -> unscheduled baseline closure
execute_plan(g, order, plan, inputs, ...)  -> ExecutionResult
compile_plan(g, order, plan, ...)          -> PlanProgram (precompiled,
                                              memoized on the plan)
RealizedTracker                            -- the measurement machinery
pack_buffers / unpack_buffer               -- move real (shaped, dtyped)
                                              tensors in/out of a planned
                                              uint8 arena (serving state)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.allocator import ArenaPlan
from repro_torch.core.graph import Graph, Node
from repro_torch.core.rewriter import FusedRegion, fuse_alias_chains
from repro_torch.kernels.arena import (
    arena_accum,
    arena_chain_write,
    arena_read,
    arena_write,
)
from repro_torch.kernels.arena.elemwise import ELEMWISE_FNS


class ExecutorError(ValueError):
    pass


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card.

    Raises when CUDA is asked for (explicitly or by default) and absent;
    there is no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ExecutorError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# Surrogate numerics: deterministic per-op value functions on flat float32
# ---------------------------------------------------------------------------

# unary elementwise ops (the in-place-eligible set plus synonyms); the
# canonical table lives in repro_torch.kernels.arena.elemwise so the fused
# chain write applies the exact same torch callables
_ELEMWISE: dict[str, Callable] = ELEMWISE_FNS

OpFn = Callable[[Node, list, int], torch.Tensor]


def _fit(x, n: int):
    """Resize a flat vector to ``n`` elements (truncate or tile)."""
    m = x.shape[0]
    if m == n:
        return x
    if m == 0:
        return torch.zeros(n, dtype=x.dtype, device=x.device)
    if m > n:
        return x[:n]
    reps = -(-n // m)
    return x.repeat(reps)[:n]


def _concat_pad(xs, n: int, device):
    """Concatenate then zero-pad/truncate to ``n`` elements.

    This is the reference semantics of ``concat``/``concat_view``: the arena
    path realizes it as back-to-back slice-writes plus a zeroed tail, so the
    reference must pad with zeros (never tile)."""
    if not xs:
        return torch.zeros(n, dtype=torch.float32, device=device)
    cc = torch.cat(xs) if len(xs) > 1 else xs[0]
    if cc.shape[0] >= n:
        return cc[:n]
    return torch.cat([cc, torch.zeros(n - cc.shape[0], dtype=cc.dtype,
                                      device=cc.device)])


def _ramp(uid: int, n: int, device):
    # per-node positional signature: makes off-by-one-slice bugs visible
    return 0.05 * torch.cos(
        torch.arange(n, dtype=torch.float32, device=device)
        * (0.37 + 0.013 * (uid % 29)))


def _blend(xs, n: int, device):
    if not xs:
        return torch.zeros(n, dtype=torch.float32, device=device)
    acc = _fit(xs[0], n)
    for x in xs[1:]:
        acc = acc + _fit(x, n)
    return acc / len(xs)


def _sig(nd: Node) -> int:
    """The node id keying the positional signature.

    Recompute clones (``repro_torch.core.rewriter.rematerialize``) carry
    their original's id as ``recompute_sig`` metadata; using it here makes a
    clone compute bit-for-bit the same value as the node it rematerializes,
    for every op — the executor-side half of the recompute contract.
    """
    for k, v in nd.meta:
        if k == "recompute_sig":
            return int(v)
    return nd.id


def _default_op(nd: Node, xs, n: int, device):
    acc = _blend(xs, n, device)
    acc = torch.tanh(acc + 0.25 * torch.roll(acc, 1))
    return 0.9 * acc + _ramp(_sig(nd), n, device)


def _partial_conv_contrib(nd: Node, branch_xs, n: int, device):
    """The per-branch accumulation step of a rewritten partial conv."""
    t = _blend(branch_xs, n, device)
    return 0.4 * torch.tanh(t + 0.25 * torch.roll(t, 1)) \
        + 0.1 * _ramp(_sig(nd), n, device)


def _split_accum(nd: Node, invals):
    """(accumulator value or None, branch values) for an accumulating node."""
    acc, branches = None, []
    for p, v in zip(nd.preds, invals):
        if p in nd.alias_preds and acc is None:
            acc = v
        else:
            branches.append(v)
    return acc, branches


def node_value(nd: Node, invals, n: int,
               registry: Mapping[str, OpFn] | None = None, *, device):
    """Reference output of ``nd`` given predecessor values (``(n,)`` f32).

    ``registry`` overrides/extends the built-in op table; entries are called
    as ``fn(node, raw_pred_values, n_elements)``.  ``device`` places the
    values a node makes from nothing (positional ramps, zero pads).
    """
    if registry is not None and nd.op in registry:
        return registry[nd.op](nd, invals, n)
    if nd.op in ("concat", "concat_view"):
        return _concat_pad(invals, n, device)
    if nd.op == "partial_conv":
        acc, branches = _split_accum(nd, invals)
        contrib = _partial_conv_contrib(nd, branches, n, device)
        return contrib if acc is None else acc + contrib
    if nd.op == "add":
        return _blend(invals, n, device)
    if nd.op in _ELEMWISE and len(invals) == 1:
        return _ELEMWISE[nd.op](_fit(invals[0], n))
    return _default_op(nd, invals, n, device)


# ---------------------------------------------------------------------------
# Input / output plumbing
# ---------------------------------------------------------------------------


def _elems(nbytes: int, what: str) -> int:
    if nbytes % 4:
        raise ExecutorError(
            f"{what}: size {nbytes} bytes is not float32-aligned (the "
            f"surrogate executor models tensors as 4-byte elements)"
        )
    return nbytes // 4


def input_nodes(g: Graph) -> list[int]:
    return [nd.id for nd in g.nodes if nd.op == "input"]


def _as_flat_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)


def _resolve_inputs(g: Graph, inputs, device) -> dict[int, torch.Tensor]:
    """Accept {name: array}, {node_id: array}, or a sequence in input-node
    id order (numpy arrays or tensors); returns flat float32 tensors on
    ``device`` keyed by node id."""
    ids = input_nodes(g)
    by_name = {g.nodes[i].name: i for i in ids}
    out: dict[int, torch.Tensor] = {}
    if inputs is None:
        inputs = {}
    if isinstance(inputs, Mapping):
        for k, v in inputs.items():
            nid = by_name.get(k, k if isinstance(k, int) else None)
            if nid is None or nid not in ids:
                raise ExecutorError(f"unknown input {k!r}")
            out[nid] = _as_flat_f32(v, device)
    else:
        vals = list(inputs)
        if len(vals) != len(ids):
            raise ExecutorError(
                f"graph has {len(ids)} inputs, got {len(vals)}")
        for nid, v in zip(ids, vals):
            out[nid] = _as_flat_f32(v, device)
    for nid in ids:
        if nid not in out:
            n = _elems(g.sizes[nid], g.nodes[nid].name)
            out[nid] = _ramp(nid, n, device) / 0.05 * 0.3
    return out


# ---------------------------------------------------------------------------
# Realized-footprint measurement
# ---------------------------------------------------------------------------


class RealizedTracker:
    """Measure the arena from executed events (DESIGN.md §6).

    Feed it each node as it executes (`step(u)`); it activates the node's
    allocation on first touch (the whole chain buffer is reserved from its
    first write) and retires an allocation one step after its last consumer
    executed — exactly the allocator's free-before-alloc event order.  Bytes
    of graph outputs stay resident to the end.

    ``peak_bytes`` is the high-water of summed live allocation sizes;
    ``extent_bytes`` the high-water of ``offset + size`` over live
    allocations.  Both are in bytes and must reproduce the plan's
    ``peak_bytes`` / ``arena_bytes`` when execution follows the planned
    order — the realized-vs-planned invariant.
    """

    def __init__(self, g: Graph, order: Sequence[int], plan: ArenaPlan,
                 steps: Sequence[Sequence[int]] | None = None):
        self._g = g
        sched = set(order)
        horizon = len(order) if steps is None else len(steps)
        self._alloc = {u: plan.allocation_of(u) for u in order}
        self._uses: dict[int, int] = {}
        self._output: dict[int, bool] = {}
        for a in {id(a): a for a in self._alloc.values()}.values():
            uses = 0
            is_out = False
            for m in a.node_ids:
                consumers = [s for s in g.succs[m] if s in sched]
                uses += len(consumers)
                is_out |= not consumers
            self._uses[id(a)] = uses
            # a plan may hold buffers past their last consumer (pinned
            # latency-class plans set t_free beyond the horizon): honor the
            # plan's lifetime, not just graph-output-ness
            self._output[id(a)] = is_out or a.t_free > horizon
        self._active: set[int] = set()
        self._pending_retire: list = []
        self._live = 0
        self.peak_bytes = 0
        self.extent_bytes = 0

    def step(self, u: int) -> None:
        self.step_group((u,))

    def step_group(self, units: Sequence[int]) -> None:
        """One time slot: all of ``units`` execute concurrently.

        Every member's allocation is activated before the slot's peak is
        sampled (co-issued outputs are live together — the step-model
        transient of ``simulate_steps``), and predecessors fully consumed by
        the slot retire at its end, landing before the next slot's allocs.
        """
        # frees scheduled from the previous step land before this alloc
        for a in self._pending_retire:
            self._active.discard(id(a))
            self._live -= a.size
        self._pending_retire = []
        for u in units:
            a = self._alloc[u]
            if id(a) not in self._active:
                self._active.add(id(a))
                self._live += a.size
                self.extent_bytes = max(self.extent_bytes, a.offset + a.size)
        self.peak_bytes = max(self.peak_bytes, self._live)
        for u in units:
            for p in self._g.nodes[u].preds:
                pa = self._alloc.get(p)
                if pa is None:
                    continue
                self._uses[id(pa)] -= 1
                if self._uses[id(pa)] == 0 and not self._output[id(pa)] \
                        and id(pa) in self._active:
                    self._pending_retire.append(pa)


# ---------------------------------------------------------------------------
# Interpreters
# ---------------------------------------------------------------------------


def reference_fn(g: Graph, registry: Mapping[str, OpFn] | None = None, *,
                 device=None) -> Callable:
    """A closure computing ``g``'s reference outputs.

    Returns ``fn(ext_vals) -> tuple`` mapping a tuple of input-node values
    (input-node id order, flat float32 on ``device``) to the tuple of
    exit-node values, with every intermediate held as its own tensor — no
    arena.  :func:`run_reference` wraps it.
    """
    dev = resolve_device(device)
    order = list(g.topo_order())
    nds = g.nodes
    elems = {u: _elems(g.sizes[u], nds[u].name) for u in order}

    def fn(ext_vals):
        env: dict[int, torch.Tensor] = {}
        it = iter(ext_vals)
        for u in order:
            nd = nds[u]
            if nd.op == "input":
                env[u] = _fit(next(it), elems[u])
            else:
                env[u] = node_value(nd, [env[p] for p in nd.preds],
                                    elems[u], registry, device=dev)
        return tuple(env[u] for u in g.exits())

    return fn


def run_reference(g: Graph, inputs=None, *,
                  registry: Mapping[str, OpFn] | None = None,
                  device=None) -> dict[str, torch.Tensor]:
    """Plain dict-storage interpreter: the executor's numeric ground truth.

    Runs ``g`` in topological order on ``device`` (``None``: the card) with
    every intermediate held as its own tensor (no arena).  Returns
    ``{node name: flat f32 value}`` for the graph outputs (nodes with no
    consumers).
    """
    dev = resolve_device(device)
    ext = _resolve_inputs(g, inputs, dev)
    vals = tuple(ext[u] for u in input_nodes(g))
    outs = reference_fn(g, registry, device=dev)(vals)
    return {g.nodes[u].name: v for u, v in zip(g.exits(), outs)}


@dataclasses.dataclass
class ExecutionResult:
    """What ``execute_plan`` produced and measured.

    ``outputs`` maps output-node names to their flat float32 values (read
    back from the final arena).  All ``*_bytes`` fields are bytes;
    ``realized_*`` are measured from execution, ``planned_*`` copied from
    the plan.
    """

    outputs: dict[str, torch.Tensor]
    realized_peak_bytes: int
    realized_arena_bytes: int
    planned_peak_bytes: int
    planned_arena_bytes: int
    order: list[int]
    impl: str
    fused: bool = False
    n_regions: int = 0

    @property
    def realized_matches_plan(self) -> bool:
        return (self.realized_peak_bytes == self.planned_peak_bytes
                and self.realized_arena_bytes == self.planned_arena_bytes)


class PlanProgram:
    """A precompiled executable for one ``(graph, order, plan)`` triple on
    one device.

    Everything derivable from the plan alone is computed once at
    construction — float32 element counts, per-node element offsets, the
    realized peak/extent (the :class:`RealizedTracker` replay is a pure
    function of the schedule), the fused-region decomposition and each
    region's elementwise tail — so calling :meth:`run` only feeds values
    through the arena program.  :func:`compile_plan` memoizes instances on
    the plan itself.

    With ``fuse=False`` the program runs the slice-per-node path (one read
    per predecessor, one write/accumulate per node).  With ``fuse=True``
    each :class:`~repro_torch.core.rewriter.FusedRegion` runs as one unit:
    the running chain value is forwarded from member to member (legal
    because an aliased predecessor has exactly one consumer — nothing else
    ever reads the interior values) and only the final member's value is
    stored, through :func:`~repro_torch.kernels.arena.arena_chain_write`
    when the region tail is pure unregistered elementwise (one launch),
    else a single ``arena_write``.  Cross-region edges still round-trip
    through the arena, so the fused path realizes the identical footprint
    (DESIGN.md §11).
    """

    def __init__(self, g: Graph, order: Sequence[int], plan: ArenaPlan, *,
                 fuse: bool = False,
                 registry: Mapping[str, OpFn] | None = None,
                 impl: str = "auto", device=None,
                 steps: Sequence[Sequence[int]] | None = None):
        self.graph = g
        self.order = list(order)
        self.plan = plan
        self.steps = None if steps is None else tuple(
            tuple(s) for s in steps)
        self.fuse = bool(fuse)
        self.registry = registry
        self.impl = impl
        self.device = resolve_device(device)
        nds = g.nodes
        self._elems = {u: _elems(g.sizes[u], nds[u].name)
                       for u in self.order}
        off = {}
        for u in self.order:
            b = plan.offset_of(u)
            if b % 4:
                raise ExecutorError(
                    f"node {nds[u].name}: planned byte offset {b} is not "
                    f"float32-aligned")
            off[u] = b // 4
        self._off = off
        self.arena_elems = -(-plan.arena_bytes // 4)
        self._input_ids = [u for u in self.order if nds[u].op == "input"]
        self._exit_ids = list(g.exits())

        # rewriter-produced views alias every predecessor; a mixed view has
        # no arena layout for the non-aliased parts — refuse rather than
        # silently diverge from run_reference
        for u in self.order:
            nd = nds[u]
            if nd.op == "concat_view" and nd.alias_preds and \
                    any(p not in nd.alias_preds for p in nd.preds):
                raise ExecutorError(
                    f"concat_view {nd.name}: preds {nd.preds} are not "
                    f"all aliased ({sorted(nd.alias_preds)}); mixed "
                    f"views are not executable")

        # a width-W step schedule executes member ops of one slot against
        # simultaneously-live storage: the plan must place every co-issued
        # slot disjointly (the steps were the plan's lifetime positions)
        if self.steps is not None:
            if [u for s in self.steps for u in s] != self.order:
                raise ExecutorError("steps do not flatten to order")
            for st in self.steps:
                if len(st) < 2:
                    continue
                in_step = set(st)
                spans = []
                for u in st:
                    if set(nds[u].preds) & in_step:
                        raise ExecutorError(
                            f"step {st} is not an antichain: {nds[u].name} "
                            f"reads a co-issued node")
                    a = plan.allocation_of(u)
                    spans.append((a.offset, a.offset + a.size, u, id(a)))
                spans.sort()
                for s0, s1 in zip(spans, spans[1:]):
                    if s1[0] < s0[1] and s1[3] != s0[3]:
                        raise ExecutorError(
                            f"co-issued nodes {nds[s0[2]].name} and "
                            f"{nds[s1[2]].name} overlap in the arena "
                            f"([{s0[0]}, {s0[1]}) vs [{s1[0]}, {s1[1]})); "
                            f"plan the arena with steps= to keep them "
                            f"disjoint")

        # realized footprint is a pure function of (g, order, plan): replay
        # it once here instead of on every execution
        tracker = RealizedTracker(g, self.order, plan, steps=self.steps)
        if self.steps is not None:
            for st in self.steps:
                tracker.step_group(st)
        else:
            for u in self.order:
                tracker.step(u)
        self.realized_peak_bytes = tracker.peak_bytes
        self.realized_arena_bytes = tracker.extent_bytes

        if self.fuse:
            self.regions = fuse_alias_chains(g, self.order, plan)
        else:
            self.regions = [FusedRegion((u,)) for u in self.order]
        # interior members forward their value (no arena write)
        self._interior = {u for r in self.regions for u in r.node_ids[:-1]}
        # collapse schedule-contiguous pure-elementwise chain runs ending at
        # a region tail into one arena_chain_write launch:
        #   {schedule position of run head: (members consumed, ops, tail id)}
        link_next: dict[int, int] = {}
        for r in self.regions:
            for a, b in zip(r.node_ids, r.node_ids[1:]):
                link_next[a] = b
        self._groups: dict[int, tuple[int, tuple[str, ...], int]] = {}
        consumed: set[int] = set()
        for i, u in enumerate(self.order):
            if i in consumed:
                continue
            j, ops = i, []
            while j + 1 < len(self.order):
                nxt = link_next.get(self.order[j])
                if nxt is None or self.order[j + 1] != nxt:
                    break
                nd = nds[nxt]
                if (nd.op not in ELEMWISE_FNS or len(nd.preds) != 1
                        or (registry is not None and nd.op in registry)):
                    break
                ops.append(nd.op)
                j += 1
            if ops and self.order[j] not in self._interior:
                self._groups[i] = (j - i, tuple(ops), self.order[j])
                consumed.update(range(i + 1, j + 1))

    @property
    def n_regions(self) -> int:
        return len(self.regions)

    @property
    def n_fused_nodes(self) -> int:
        """Chain members executed without their own arena write."""
        return sum(len(r) - 1 for r in self.regions)

    # -- program body ------------------------------------------------------

    def _zero_view_tail(self, arena, u):
        # concat_view parts already sit back-to-back inside this buffer: the
        # concat never materializes.  Zero any tail the parts do not cover
        # so the view equals the reference's zero-pad.
        n, covered = self._elems[u], sum(self._elems[p]
                                         for p in self.graph.nodes[u].preds)
        if covered < n:
            arena_write(arena, torch.zeros(n - covered, dtype=torch.float32,
                                           device=self.device),
                        self._off[u] + covered, impl=self.impl)

    def _body_slice(self, arena, ext_it):
        """Slice-per-node: one read per predecessor, one store per node."""
        nds = self.graph.nodes
        elems, off = self._elems, self._off
        impl, registry, dev = self.impl, self.registry, self.device
        for u in self.order:
            nd = nds[u]
            if nd.op == "concat_view" and nd.alias_preds:
                self._zero_view_tail(arena, u)
                continue
            if nd.op == "input":
                arena_write(arena, next(ext_it), off[u], impl=impl)
                continue
            invals = [arena_read(arena, off[p], elems[p], impl=impl)
                      for p in nd.preds]
            if nd.op == "partial_conv" and nd.alias_preds and \
                    (registry is None or nd.op not in registry):
                # in-place accumulation into the (aliased) running output —
                # a true read-modify-write of the shared slice
                branches = [v for p, v in zip(nd.preds, invals)
                            if p not in nd.alias_preds]
                contrib = _partial_conv_contrib(nd, branches, elems[u], dev)
                arena_accum(arena, contrib, off[u], impl=impl)
                continue
            arena_write(arena, node_value(nd, invals, elems[u], registry,
                                          device=dev),
                        off[u], impl=impl)

    def _body_fused(self, arena, ext_it):
        """Fused: chain members forward their value; only the region tail
        stores.  Legal because an aliased predecessor has exactly one
        consumer — the next chain member — so nothing an interleaved node
        does can observe (or clobber: the chain's allocation is live
        throughout) the skipped interior stores.  Schedule-contiguous
        pure-elementwise runs ending at a tail execute as one
        ``arena_chain_write`` launch."""
        nds = self.graph.nodes
        elems, off = self._elems, self._off
        impl, registry, dev = self.impl, self.registry, self.device
        order = self.order
        fwd: dict = {}
        i = 0
        while i < len(order):
            u = order[i]
            nd = nds[u]
            if nd.op == "concat_view" and nd.alias_preds:
                self._zero_view_tail(arena, u)
                i += 1
                continue
            if nd.op == "input":
                val = next(ext_it)
            else:
                invals = [fwd[p] if p in fwd
                          else arena_read(arena, off[p], elems[p], impl=impl)
                          for p in nd.preds]
                val = node_value(nd, invals, elems[u], registry, device=dev)
                for p in nd.preds:
                    fwd.pop(p, None)  # single consumer: value is dead now
            grp = self._groups.get(i)
            if grp is not None:
                m, ops, out = grp
                arena_chain_write(arena, val, off[out], ops, impl=impl)
                i += m + 1
                continue
            if u in self._interior:
                fwd[u] = val
            else:
                arena_write(arena, val, off[u], impl=impl)
            i += 1

    # -- entry point -------------------------------------------------------

    def resolve_ext(self, inputs) -> tuple:
        """Flatten/resize user inputs to the program's input tuple."""
        ext = _resolve_inputs(self.graph, inputs, self.device)
        return tuple(_fit(ext[u], self._elems[u]) for u in self._input_ids)

    def run(self, inputs=None, *, arena=None,
            strict: bool = True) -> ExecutionResult:
        """Execute the program; see :func:`execute_plan` for semantics."""
        plan = self.plan
        ext_vals = self.resolve_ext(inputs)
        if arena is None:
            arena = torch.zeros(self.arena_elems, dtype=torch.float32,
                                device=self.device)
        else:
            if not isinstance(arena, torch.Tensor) \
                    or arena.dtype != torch.float32 or arena.dim() != 1 \
                    or not arena.is_contiguous() \
                    or arena.device != self.device:
                raise ExecutorError(
                    f"arena must be a contiguous 1-D float32 tensor on "
                    f"{self.device}")
            if strict and arena.shape[0] < self.arena_elems:
                raise ExecutorError(
                    f"supplied arena has {arena.shape[0]} elements "
                    f"({arena.shape[0] * 4} bytes) < planned arena_bytes "
                    f"{plan.arena_bytes}")
        if strict and (self.realized_peak_bytes != plan.peak_bytes
                       or self.realized_arena_bytes != plan.arena_bytes):
            raise ExecutorError(
                f"realized arena diverges from plan: peak "
                f"{self.realized_peak_bytes} vs planned {plan.peak_bytes}, "
                f"extent {self.realized_arena_bytes} vs planned "
                f"{plan.arena_bytes}")

        body = self._body_fused if self.fuse else self._body_slice
        body(arena, iter(ext_vals))
        outs = [arena_read(arena, self._off[u], self._elems[u],
                           impl=self.impl) for u in self._exit_ids]

        nds = self.graph.nodes
        return ExecutionResult(
            outputs={nds[u].name: v for u, v in zip(self._exit_ids, outs)},
            realized_peak_bytes=self.realized_peak_bytes,
            realized_arena_bytes=self.realized_arena_bytes,
            planned_peak_bytes=plan.peak_bytes,
            planned_arena_bytes=plan.arena_bytes,
            order=list(self.order),
            impl=self.impl,
            fused=self.fuse,
            n_regions=self.n_regions,
        )


_PROGRAM_CACHE_CAP = 8


def compile_plan(
    g: Graph,
    order: Sequence[int],
    plan: ArenaPlan,
    *,
    fuse: bool = False,
    registry: Mapping[str, OpFn] | None = None,
    impl: str = "auto",
    device=None,
    steps: Sequence[Sequence[int]] | None = None,
) -> PlanProgram:
    """Build (or fetch) the :class:`PlanProgram` for this plan on ``device``
    (``None``: the card).

    Programs are memoized on the plan object itself (like its offset
    index), keyed by the schedule, the device and the execution options, so
    repeat executions skip the per-plan precomputation; a program built for
    one device is never reused on another.  The cache is dropped on
    pickling (``ArenaPlan.__getstate__``) and capped per plan.
    """
    dev = resolve_device(device)
    steps_key = None if steps is None else tuple(tuple(s) for s in steps)
    key = (id(g), tuple(order), bool(fuse), impl, str(dev),
           None if registry is None else id(registry), steps_key)
    cache = plan.__dict__.setdefault("_programs", {})
    prog = cache.get(key)
    # ids can be recycled after gc: accept a hit only if it still points at
    # the same live objects
    if prog is not None and prog.graph is g and \
            (registry is None or prog.registry is registry):
        return prog
    prog = PlanProgram(g, order, plan, fuse=fuse, registry=registry,
                       impl=impl, device=dev, steps=steps)
    cache[key] = prog
    while len(cache) > _PROGRAM_CACHE_CAP:
        cache.pop(next(iter(cache)))
    return prog


def execute_plan(
    g: Graph,
    order: Sequence[int],
    plan: ArenaPlan,
    inputs=None,
    *,
    registry: Mapping[str, OpFn] | None = None,
    impl: str = "auto",
    device=None,
    arena=None,
    strict: bool = True,
    fuse: bool = False,
    steps: Sequence[Sequence[int]] | None = None,
) -> ExecutionResult:
    """Run schedule ``order`` of ``g`` against the planned arena.

    Args:
      g: the graph to execute (typically ``Plan.graph`` — i.e.
        post-rewrite, so alias chains are present).
      order: the schedule to execute; must be the order ``plan`` was built
        from (the realized-vs-planned invariant is asserted against it).
      plan: the :class:`ArenaPlan` whose byte offsets place every tensor.
      inputs: input-node values ({name: array}, {node_id: array}, or a
        sequence in input-node order; numpy arrays or tensors); missing
        inputs get a deterministic per-node default.  Values are flattened
        to float32 on ``device``.
      registry: optional op-function overrides (see :func:`node_value`).
      impl: arena op dispatch — 'auto' (the CUDA kernels on the card, the
        plain versions on the CPU), 'cuda', or 'torch' (the plain versions
        anywhere, only when asked for).
      device: where to run; ``None`` means the card and raises when CUDA is
        absent.  Pass ``'cpu'`` to run on the CPU.
      arena: optional float32 tensor of at least ``plan.arena_bytes / 4``
        elements on ``device`` to execute in (reused storage, e.g. across
        decode steps).  It is written in place — the port's counterpart of
        donating the buffer.  Allocated fresh (zeroed) when ``None``.
      strict: assert the realized-vs-planned invariant and that the arena
        is large enough.
      fuse: execute in-place alias chains as fused regions — value
        forwarding between members, one write (or one chain-kernel launch)
        per region instead of per node (DESIGN.md §11).
      steps: optional width-W step schedule (must flatten to ``order``, and
        ``plan`` must have been packed with the same ``steps``).  Values
        still stream through the arena one op at a time, but the realized
        footprint is replayed in step groups, so the realized-vs-planned
        invariant checks the *concurrent* peak (DESIGN.md §12).

    Returns:
      :class:`ExecutionResult` with output values and the measured
      realized peak/extent bytes.
    """
    return compile_plan(g, order, plan, fuse=fuse, registry=registry,
                        impl=impl, device=device, steps=steps).run(
        inputs, arena=arena, strict=strict)


# ---------------------------------------------------------------------------
# Real-tensor arena packing (serving state)
# ---------------------------------------------------------------------------


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _to_bytes(x, device) -> torch.Tensor:
    """Flatten any (non-bool) array to its raw little-endian uint8 bytes."""
    t = torch.as_tensor(x)
    if t.dtype == torch.bool:
        raise ExecutorError("bool tensors cannot be arena-packed")
    return t.to(device).contiguous().reshape(-1).view(torch.uint8)


def pack_buffers(plan: ArenaPlan, arrays: Mapping[int, object], *,
                 arena=None, impl: str = "auto",
                 device=None) -> torch.Tensor:
    """Pack real tensors into one uint8 arena at their planned byte offsets.

    ``arrays`` maps node ids (of the graph the plan was built from) to
    arbitrarily shaped/dtyped tensors or numpy arrays; each must fit the
    node's planned span in bytes.  Returns the uint8 arena of
    ``plan.arena_bytes`` bytes on ``device`` (``None``: the card).  A
    supplied ``arena`` (uint8, on ``device``) is written in place.  Used by
    the serving driver to realize the decode-state plan (DESIGN.md §1/§6).
    """
    dev = resolve_device(device)
    items = sorted(arrays.items())
    for nid, x in items:
        a = plan.allocation_of(nid)
        span = a.size - a.intra.get(nid, 0)
        t = torch.as_tensor(x)
        nbytes = t.numel() * t.element_size()
        if nbytes > span:
            raise ExecutorError(
                f"node {nid}: {nbytes} bytes exceed planned span {span}")
    if arena is None:
        arena = torch.zeros(plan.arena_bytes, dtype=torch.uint8, device=dev)
    elif not isinstance(arena, torch.Tensor) or arena.dtype != torch.uint8 \
            or arena.device != dev:
        raise ExecutorError(f"arena must be a uint8 tensor on {dev}")
    for nid, x in items:
        arena_write(arena, _to_bytes(x, dev), plan.offset_of(nid), impl=impl)
    return arena


def unpack_buffer(arena, plan: ArenaPlan, node_id: int, shape, dtype, *,
                  impl: str = "auto") -> torch.Tensor:
    """Read one planned tensor back out of a uint8 arena (a fresh tensor
    on the arena's device)."""
    dt = _torch_dtype(dtype)
    nbytes = int(np.prod(shape)) * dt.itemsize
    b = arena_read(arena, plan.offset_of(node_id), nbytes, impl=impl)
    return b.view(dt).reshape(shape)
