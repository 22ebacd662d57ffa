"""SERENITY <-> PyTorch FX: schedule aten graphs for minimal live memory.

The port's counterpart of ``src/repro/core/jax_bridge.py``.  The paper
schedules operator graphs of edge networks; an aten graph traced from a
PyTorch function is the same thing one level down: a DAG of ops whose issue
order determines how long each output tensor stays live.  Reordering the
ops with the paper's DP lowers the activation high-watermark the way the
paper lowers TFLite's arena peak, and :func:`compile_scheduled` runs the
reordered program in one planned uint8 arena, every threaded intermediate
written and read through the port's arena kernels
(:mod:`repro_torch.kernels.arena`: ``csrc/arena.cu`` on the card).

Tracing
-------
:func:`trace_fn` lifts ``fn`` with ``make_fx(functionalize(fn),
tracing_mode="fake")``: functional aten ops, one graph node per aten call,
shapes and dtypes from fake tensors (nothing is allocated).  The tensor
leaves of ``(args, kwargs)`` become the placeholders, in pytree order;
other leaves are traced in as constants.  The output node returns the
flattened output leaves; ``gm.meta["out_spec"]`` rebuilds the caller's
structure.

Lifting rules (:func:`fx_to_graph`), as ``jaxpr_to_graph`` lifts a jaxpr
----------------------------------------------------------------------
* **Node order.**  Placeholders are nodes ``0..n_in-1`` (``op="input"``),
  then one node per ``call_function``, in graph order, whose cost is the
  bytes of its outputs (``node.meta["val"]``).
* **Constants.**  ``get_attr`` constants are not nodes: they stay in the
  environment, as a jaxpr's ``constvars`` do.
* **Multi-output ops.**  A node that returns a tuple or list is one graph
  node whose outputs lie back to back in its slice, as an equation's
  ``outvars`` do; each ``operator.getitem`` resolves to its producer and
  index and is not a node of its own.
* **Threadable tensors.**  Byte size > 0, not ``bool``, itemsize in
  (1, 2, 4, 8).  Everything else stays in the environment and is counted in
  ``n_env_bypassed``.
* Ops that mutate (a schema with a mutable argument) are refused: the
  bridge schedules functional programs.

Public API
----------
fx_config(...)                       -> the PlanConfig of bridge scheduling
trace_fn(fn, *args, **kwargs)        -> GraphModule (functional aten)
fx_to_graph(gm)                      -> (Graph, node_ids)
schedule_fx(gm, ...)                 -> (reordered GraphModule, report)
serenity_transform(fn)(*args)        -> fn with memory-optimal op order
compile_scheduled(fn)(*args)         -> fn run through the planned arena
                                        (realized footprint measured;
                                        ``jit=True``: one CUDA graph per
                                        input signature)
analyze_fn(fn, *args)                -> footprint report (no transform)
memory_aware_remat(fn, budget, *args)-> fn or a checkpointed fn, chosen by
                                        the scheduler's footprint analysis

Not ported: ``repro``'s deprecated keyword shims (``state_quota`` and
``beam_fallback`` as keywords); pass ``config=fx_config(...)``.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree
from torch import fx
from torch.func import functionalize
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils.checkpoint import checkpoint

from repro_torch.core.allocator import ArenaPlan, plan_arena_best
from repro_torch.core.capture import CapturedCall
from repro_torch.core.executor import (
    ExecutorError,
    RealizedTracker,
    resolve_device,
)
from repro_torch.core.graph import Graph, simulate_schedule
from repro_torch.core.heuristics import kahn_schedule
from repro_torch.core.plancache import PlanCache, resolve as _resolve_cache
from repro_torch.core.serenity import PlanConfig, plan as serenity_plan
from repro_torch.kernels import _grad
from repro_torch.kernels.arena import arena_read, arena_write


def fx_config(state_quota: int = 4000,
              on_timeout: str = "adaptive") -> PlanConfig:
    """The default :class:`PlanConfig` for aten-graph scheduling.

    Aten graphs are planned without the paper's graph rewrites (node ids
    must survive verbatim so the reordered graph can be rebuilt) and
    without heuristic baselines (the bridge computes its own traced / Kahn
    candidates).
    """
    return PlanConfig(rewrite=False, inplace=False, compute_baselines=False,
                      state_quota=state_quota, on_timeout=on_timeout)


# ---------------------------------------------------------------------------
# Tracing and lifting
# ---------------------------------------------------------------------------


def _split_leaves(args, kwargs):
    """(tensor leaves, a function of the tensor leaves that rebuilds every
    leaf, the input treespec, the non-tensor leaves)."""
    leaves, spec = pytree.tree_flatten((args, kwargs))
    slots = [i for i, v in enumerate(leaves) if isinstance(v, torch.Tensor)]
    tensors = [leaves[i] for i in slots]

    def rebuild(ts):
        full = list(leaves)
        for i, t in zip(slots, ts):
            full[i] = t
        return pytree.tree_unflatten(full, spec)

    consts = tuple((i, v) for i, v in enumerate(leaves)
                   if not isinstance(v, torch.Tensor))
    return tensors, rebuild, spec, consts


def trace_fn(fn: Callable, *args, **kwargs) -> fx.GraphModule:
    """Trace ``fn(*args, **kwargs)`` into a functional aten GraphModule
    (fake tensors: nothing is computed or allocated).

    Its placeholders are the tensor leaves of ``(args, kwargs)`` in pytree
    order; it returns the output leaves as a tuple, and
    ``gm.meta["out_spec"]`` is their treespec.
    """
    tensors, rebuild, _, _ = _split_leaves(args, kwargs)
    box = {}

    def flat_fn(*ts):
        a, kw = rebuild(list(ts))
        out, box["spec"] = pytree.tree_flatten(fn(*a, **kw))
        return tuple(out)

    gm = make_fx(functionalize(flat_fn), tracing_mode="fake",
                 _allow_non_fake_inputs=True)(*(t.detach() for t in tensors))
    gm.meta["out_spec"] = box["spec"]
    return gm


def _val_bytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    return 0


def _outputs_of(node: fx.Node) -> list:
    """The values a node produces: its meta value, or each element of a
    tuple/list one."""
    val = node.meta.get("val")
    return list(val) if isinstance(val, (tuple, list)) else [val]


def _multi(node: fx.Node) -> bool:
    return isinstance(node.meta.get("val"), (tuple, list))


def _is_getitem(node: fx.Node) -> bool:
    return node.op == "call_function" and node.target is operator.getitem


def _lifted(gm: fx.GraphModule) -> list[fx.Node]:
    """The fx nodes that become graph nodes, in graph-node order."""
    nodes = list(gm.graph.nodes)
    for n in nodes:
        if n.op in ("call_module", "call_method"):
            raise ValueError(f"fx_to_graph takes aten graphs (trace_fn); "
                             f"found {n.op} {n.target}")
        if n.op == "call_function" and not _is_getitem(n):
            schema = getattr(n.target, "_schema", None)
            if schema is not None and schema.is_mutable:
                raise ValueError(
                    f"{n.target} mutates an argument; the bridge schedules "
                    f"functional programs (trace_fn functionalizes)")
    return ([n for n in nodes if n.op == "placeholder"]
            + [n for n in nodes
               if n.op == "call_function" and not _is_getitem(n)])


def fx_to_graph(gm: fx.GraphModule) -> tuple[Graph, dict]:
    """Lift an aten GraphModule into the SERENITY IR (the module
    docstring's lifting rules).

    Returns ``(graph, node_ids)``: ``node_ids[n]`` is the graph node id of
    fx node ``n`` (placeholders and every ``call_function`` but
    ``operator.getitem``).
    """
    node_ids: dict[fx.Node, int] = {}
    specs: list[dict] = []
    for n in _lifted(gm):
        preds = set()
        for a in n.all_input_nodes:
            if _is_getitem(a):
                a = a.args[0]
            if a in node_ids:
                preds.add(node_ids[a])
        nid = len(specs)
        if n.op == "placeholder":
            specs.append(dict(name=f"in{nid}", op="input",
                              size_bytes=_val_bytes(n.meta.get("val")),
                              preds=[]))
        else:
            specs.append(dict(
                name=n.name, op=str(n.target),
                size_bytes=sum(_val_bytes(v) for v in _outputs_of(n)),
                preds=sorted(preds)))
        node_ids[n] = nid
    return Graph.build(specs, name="fx"), node_ids


# ---------------------------------------------------------------------------
# Scheduling
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FxScheduleReport:
    """Footprint accounting for one scheduled aten graph.  All ``*_peak``/
    ``*_bytes`` fields are bytes; ``order`` indexes the lifted graph's
    nodes (placeholders first, then ops)."""

    n_eqns: int                    # ops (call_function nodes but getitem)
    original_peak: int             # live-bytes peak of the traced op order
    kahn_peak: int                 # peak of the Kahn/TFLite-style order
    optimal_peak: int              # peak of the chosen (best) order
    exact: bool                    # False if the beam fallback was used
    order: list[int]
    arena_bytes: int = 0           # offset-allocator watermark of the order
    arena_policy: str = ""         # winning placement policy
    realized_bytes: int = 0        # live-byte high-water of the planned
                                   # lifetimes replayed over the executed
                                   # order (0 = not run; set by
                                   # compile_scheduled)
    n_env_bypassed: int = 0        # tensors kept out of the arena (unsized
                                   # or non-byteable dtypes)
    arena_plan: "ArenaPlan | None" = None   # full offset plan of the order
    n_arena_writes: int = 0        # arena_write calls per run (one per
                                   # threaded tensor; set by
                                   # compile_scheduled)
    n_arena_reads: int = 0         # arena_read calls per run (one per op
                                   # and distinct threaded input)

    @property
    def reduction_vs_original(self) -> float:
        return self.original_peak / max(self.optimal_peak, 1)

    @property
    def arena_over_peak(self) -> float:
        """Fragmentation ratio: 1.0 == the arena realizes the liveness peak."""
        return self.arena_bytes / max(self.optimal_peak, 1)

    @property
    def realized_matches_plan(self) -> bool:
        """True when the measured high-water equals the planned peak."""
        return self.realized_bytes == self.optimal_peak


def _reordered(gm: fx.GraphModule, order, node_ids) -> fx.GraphModule:
    """``gm`` with its ops in ``order`` (placeholders and constants first,
    each ``getitem`` right after its producer, the output last)."""
    by_id = {nid: n for n, nid in node_ids.items()}
    getitems: dict[fx.Node, list] = {}
    for n in gm.graph.nodes:
        if _is_getitem(n):
            getitems.setdefault(n.args[0], []).append(n)
    graph = fx.Graph()
    env: dict[fx.Node, fx.Node] = {}

    def copy(n):
        env[n] = graph.node_copy(n, lambda a: env[a])
        for u in getitems.get(n, ()):
            copy(u)

    for n in gm.graph.nodes:
        if n.op in ("placeholder", "get_attr"):
            copy(n)
    for nid in order:
        if by_id[nid].op != "placeholder":
            copy(by_id[nid])
    copy(gm.graph.output_node())
    new = fx.GraphModule(gm, graph)
    new.meta.update(gm.meta)
    return new


def schedule_fx(gm: fx.GraphModule, *,
                cache: "PlanCache | bool | None" = True,
                config: PlanConfig | None = None):
    """Reorder the ops of ``gm`` into a memory-optimal order.

    Orders are memoized in the content-addressed plan cache keyed on the
    lifted graph plus the serialized config, so re-tracing the same
    function schedules in O(graph hash).

    Args:
      gm: an aten GraphModule (:func:`trace_fn`).
      cache: plan-cache handle/boolean as in :func:`repro_torch.core.plan`.
      config: planning knobs (:func:`fx_config` defaults when ``None``):
        the DP runs under ``config.state_quota`` and
        ``config.on_timeout='adaptive'`` falls back to the Algorithm 2
        budget meta-search and a bounded per-cell beam on quota exhaustion
        (the report's ``exact`` flag records whether any fallback produced
        the order) while ``'raise'`` propagates
        :class:`~repro_torch.core.scheduler.SearchTimeout`.

    Returns:
      ``(new_gm, report)``: the same program with its ops permuted into the
      best order found (never worse than the traced order), and a
      :class:`FxScheduleReport` with the byte peaks of the traced / Kahn /
      chosen orders plus the offset-allocator watermark (``arena_bytes``,
      bytes) of the chosen order.
    """
    if config is None:
        config = fx_config()
    g, node_ids = fx_to_graph(gm)

    pc = _resolve_cache(cache)
    cache_opts = ("fx_bridge.schedule_fx", config.cache_key())
    cached = pc.get(g, cache_opts) if pc is not None else None
    if cached is not None:
        (best_peak, best_order, exact, orig_peak, kahn_peak, arena) = cached
    else:
        # footprints of the traced order and the Kahn order: both feasible
        # schedules, so the chosen order is never worse than either
        orig_order = list(range(len(g)))
        orig = simulate_schedule(g, orig_order)
        kahn = kahn_schedule(g)

        # hierarchical divide and conquer + branch-and-bound DP per cell
        res = serenity_plan(g, config, cache=pc if pc is not None else False)
        exact = res.exact

        candidates = [
            (orig.peak_bytes, orig_order),
            (kahn.peak_bytes, kahn.order),
            (res.peak_bytes, res.order),
        ]
        best_peak, best_order = min(candidates, key=lambda c: c[0])
        orig_peak, kahn_peak = orig.peak_bytes, kahn.peak_bytes
        # the full offset plan rides the cache so compile_scheduled never
        # replans
        arena = (res.arena if best_order is res.order
                 else plan_arena_best(g, best_order))
        if pc is not None:
            pc.put(g, cache_opts,
                   (best_peak, list(best_order), exact, orig_peak, kahn_peak,
                    arena))
    report = FxScheduleReport(
        n_eqns=len(g) - sum(n.op == "placeholder" for n in node_ids),
        original_peak=orig_peak,
        kahn_peak=kahn_peak,
        optimal_peak=best_peak,
        exact=exact,
        order=list(best_order),
        arena_bytes=arena.arena_bytes,
        arena_policy=arena.policy,
        arena_plan=arena,
    )
    return _reordered(gm, best_order, node_ids), report


def serenity_transform(fn: Callable, **kw) -> Callable:
    """Return ``fn`` with its aten ops in memory-optimal order.  The
    returned callable runs the reordered GraphModule (aten ops, so autograd
    flows through it) and exposes ``.report`` after its first call."""
    def wrapped(*args, **kwargs):
        gm = trace_fn(fn, *args, **kwargs)
        new_gm, report = schedule_fx(gm, **kw)
        wrapped.report = report
        tensors, _, _, _ = _split_leaves(args, kwargs)
        return pytree.tree_unflatten(list(new_gm(*tensors)),
                                     gm.meta["out_spec"])

    wrapped.report = None
    return wrapped


# ---------------------------------------------------------------------------
# Arena-threaded execution: realize the planned offsets (DESIGN.md §6)
# ---------------------------------------------------------------------------


def _threadable(v) -> bool:
    return (isinstance(v, torch.Tensor) and _val_bytes(v) > 0
            and v.dtype != torch.bool and v.element_size() in (1, 2, 4, 8))


def _value_key(a: fx.Node) -> tuple:
    """The value an argument names: ``(producer, index)``, index None for
    a single-output node (or a constant)."""
    if _is_getitem(a):
        return (a.args[0], a.args[1])
    return (a, None)


def _to_bytes(val) -> torch.Tensor:
    return val.contiguous().reshape(-1).view(torch.uint8)


def _build_arena_program(gm: fx.GraphModule, node_ids: dict, order,
                         plan: ArenaPlan):
    """Compile the scheduled aten graph into ``run(arena, flat_tensors) ->
    flat outputs`` where every threadable intermediate lives as a byte
    slice of the uint8 ``arena`` at its planned offset.

    Each threaded tensor is written once, through ``arena_write``, when it
    is produced; each op reads each distinct threaded input once, through
    ``arena_read``, into a fresh tensor (no view of the arena reaches an
    op, so no offset needs the itemsize's alignment and no aliasing op can
    hand out bytes a later write overwrites).  Outputs leave the arena when
    they are produced, as the tensors the ops returned.

    ``node_ids`` is :func:`fx_to_graph`'s map of ``gm``'s nodes.  Returns
    ``(run, n_env_bypassed, writes per run, reads per run)``; ``run``'s
    ``impl`` is the arena ops' (``'torch'`` runs the same program through
    their plain versions, to hold the kernels against).
    """
    by_id = {nid: n for n, nid in node_ids.items()}
    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    slot = {n: i for i, n in enumerate(placeholders)}
    # a value is (producer, index): index None for a single-output node;
    # a threaded value's entry is (byte offset, bytes, shape, dtype)
    addr: dict[tuple, tuple] = {}
    bypassed = 0
    for n, nid in node_ids.items():
        cursor = plan.offset_of(nid)
        multi = _multi(n)
        for i, v in enumerate(_outputs_of(n)):
            if _threadable(v):
                addr[(n, i if multi else None)] = (
                    cursor, _val_bytes(v), tuple(v.shape), v.dtype)
            else:
                bypassed += 1
            cursor += _val_bytes(v)
    consts = {(n, None): functools.reduce(getattr, n.target.split("."), gm)
              for n in gm.graph.nodes if n.op == "get_attr"}
    # per op: the distinct threaded values it reads, in argument order
    reads_of = {n: list(dict.fromkeys(
        k for k in map(_value_key, n.all_input_nodes) if k in addr))
        for n in node_ids if n.op != "placeholder"}
    outs = gm.graph.output_node().args[0]
    out_keys = {_value_key(a) for a in outs if isinstance(a, fx.Node)}
    n_reads = sum(len(r) for r in reads_of.values())

    def run(arena, flat_args, impl="auto"):
        env: dict[tuple, Any] = dict(consts)
        # outputs escape the arena at production time: the planner is free
        # to reuse their bytes afterwards
        captured: dict[tuple, Any] = {}

        def write(key, val):
            if key in out_keys:
                captured[key] = val
            if key in addr:
                arena_write(arena, _to_bytes(val), addr[key][0], impl=impl)
            else:
                env[key] = val

        for nid in order:
            n = by_id[nid]
            if n.op == "placeholder":
                write((n, None), flat_args[slot[n]])
                continue
            fresh = {}
            for k in reads_of[n]:
                off, nbytes, shape, dtype = addr[k]
                fresh[k] = arena_read(arena, off, nbytes, impl=impl) \
                    .view(dtype).reshape(shape)

            def val(a):
                k = _value_key(a)
                return fresh[k] if k in fresh else env[k]

            ans = n.target(*fx.node.map_arg(n.args, val),
                           **fx.node.map_arg(n.kwargs, val))
            # the op's fresh inputs, and its output once written, are
            # released here rather than when the next op rebinds them
            fresh.clear()
            if _multi(n):
                for i, v in enumerate(ans):
                    write((n, i), v)
            else:
                write((n, None), ans)
            ans = None

        def out(a):
            if not isinstance(a, fx.Node):
                return a
            k = _value_key(a)
            return captured[k] if k in captured else env[k]

        return tuple(out(a) for a in outs)

    return run, bypassed, len(addr), n_reads


@dataclasses.dataclass
class ScheduledProgram:
    """One input signature's compiled arena program (see
    :func:`compile_scheduled`): ``run(arena, flat_tensors)``, its report,
    the outputs' treespec, and with ``jit=True`` its capture
    (:class:`~repro_torch.core.capture.CapturedCall`) and the static
    tensors (arena and inputs) the capture reads."""

    run: Callable
    report: FxScheduleReport
    out_spec: Any
    capture: "CapturedCall | None" = None
    static: tuple = ()


def compile_scheduled(fn: Callable, *, device=None, jit: bool = False,
                      cache: "PlanCache | bool | None" = True,
                      assert_equiv: bool = True, atol: float = 1e-5,
                      config: PlanConfig | None = None) -> Callable:
    """``fn`` with its ops reordered *and executed through the planned
    arena*: every threadable intermediate is written and read as a byte
    slice of one uint8 tensor of ``report.arena_bytes`` bytes on ``device``
    at its :class:`~repro_torch.core.allocator.ArenaPlan` offset, through
    ``arena_write`` / ``arena_read`` (on the card ``csrc/arena.cu``'s
    kernels; a CUDA tensor launches them or raises).

    ``device=None`` means the card, and raises without one; the tensor
    inputs must lie on ``device``.  The arena program has no backward (its
    values pass through uint8 bytes autograd cannot see through): under
    autograd, an input that requires a gradient raises
    ``NotImplementedError`` on any device rather than return detached
    outputs; :func:`serenity_transform` is the differentiable reorder.  The wrapper compiles per input
    signature (input treespec, each tensor's shape, dtype and device, the
    other leaves' values).  On each first call for a signature it:

      1. traces ``fn`` (:func:`trace_fn`) and schedules it
         (:func:`schedule_fx`; the plan cache makes a retrace cheap);
      2. builds the arena program over the chosen order and the plan;
      3. runs it: eagerly, or with ``jit=True`` (the counterpart of
         ``repro``'s ``jax.jit(run)``) as the warm-up of a CUDA graph
         captured for the signature (:class:`CapturedCall`; a CPU has
         none, and there ``jit=True`` raises).  Later calls copy their
         inputs into the capture's static tensors, replay, and return
         clones of the capture's outputs, so a replay never overwrites
         what an earlier call returned;
      4. with ``assert_equiv`` (default), also runs the *unscheduled*
         ``fn`` and checks every output within ``atol`` (rtol = atol):
         arena transparency is checked, not assumed;
      5. replays the executed order's alloc/free events through
         :class:`~repro_torch.core.executor.RealizedTracker` into
         ``report.realized_bytes``, and records the arena calls per run
         (``n_arena_writes``, ``n_arena_reads``) and the bypassed tensors.

    Returns the wrapped callable; ``wrapped.report`` and
    ``wrapped.program`` (a :class:`ScheduledProgram`) are those of the most
    recent call.
    """
    dev = resolve_device(device)
    if jit and dev.type != "cuda":
        raise ExecutorError(
            f"jit=True captures the program in a CUDA graph, and {dev} has "
            f"none; run with jit=False there")
    if config is None:
        config = fx_config()
    compiled: dict[Any, ScheduledProgram] = {}

    def wrapped(*args, **kwargs):
        tensors, _, in_spec, consts = _split_leaves(args, kwargs)
        if _grad.needs_grad(*tensors):
            raise NotImplementedError(
                "compile_scheduled: an input requires a gradient, and the "
                "arena program has no backward (its values pass through a "
                "uint8 arena); call it under torch.no_grad(), or use "
                "serenity_transform, which autograd flows through")
        for t in tensors:
            if t.device != dev:
                raise ExecutorError(
                    f"an input lies on {t.device}; this program runs on "
                    f"{dev}")
        key = (in_spec, consts, tuple((tuple(t.shape), t.dtype)
                                      for t in tensors))
        prog = compiled.get(key)
        first_call = prog is None
        if first_call:
            gm = trace_fn(fn, *args, **kwargs)
            _, report = schedule_fx(gm, config=config, cache=cache)
            g, node_ids = fx_to_graph(gm)
            plan = report.arena_plan or plan_arena_best(g, report.order)
            run, bypassed, n_writes, n_reads = _build_arena_program(
                gm, node_ids, report.order, plan)
            tracker = RealizedTracker(g, report.order, plan)
            for u in report.order:
                tracker.step(u)
            report.realized_bytes = tracker.peak_bytes
            report.n_env_bypassed = bypassed
            report.n_arena_writes = n_writes
            report.n_arena_reads = n_reads
            prog = compiled[key] = ScheduledProgram(
                run, report, gm.meta["out_spec"])
        wrapped.report, wrapped.program = prog.report, prog
        arena_bytes = max(prog.report.arena_bytes, 1)
        if not jit:
            arena = torch.empty(arena_bytes, dtype=torch.uint8, device=dev)
            flat = prog.run(arena, tensors)
        elif first_call:
            static = (torch.empty(arena_bytes, dtype=torch.uint8,
                                  device=dev),
                      tuple(t.detach().clone() for t in tensors))
            prog.capture = CapturedCall(
                lambda: prog.run(static[0], static[1]), dev)
            prog.static = static
            flat = _cloned(prog.capture.first)
        else:
            for dst, t in zip(prog.static[1], tensors):
                dst.copy_(t)
            flat = _cloned(prog.capture.replay())
        result = pytree.tree_unflatten(list(flat), prog.out_spec)
        if assert_equiv and first_call:
            ref = fn(*args, **kwargs)
            for a, b in zip(pytree.tree_leaves(result),
                            pytree.tree_leaves(ref)):
                torch.testing.assert_close(a, b, atol=atol, rtol=atol)
        return result

    wrapped.report = None
    wrapped.program = None
    return wrapped


def _cloned(outs) -> tuple:
    return tuple(o.clone() if isinstance(o, torch.Tensor) else o
                 for o in outs)


def analyze_fn(fn: Callable, *args, **kw) -> FxScheduleReport:
    """The footprint report of ``fn``'s traced ops (no transform)."""
    _, report = schedule_fx(trace_fn(fn, *args), **kw)
    return report


def memory_aware_remat(fn: Callable, budget_bytes: int, *abstract_args,
                       **kw) -> tuple[Callable, dict]:
    """Budget-driven remat choice (the paper's cap, our policy knob):

    analyze ``fn``'s optimal schedule footprint; if even the optimal order
    exceeds the budget, return ``fn`` under
    ``torch.utils.checkpoint.checkpoint`` (trading recompute for liveness),
    else return ``fn`` itself.
    """
    report = analyze_fn(fn, *abstract_args, **kw)
    decision = {
        "optimal_peak": report.optimal_peak,
        "budget": budget_bytes,
        "remat": report.optimal_peak > budget_bytes,
        "exact": report.exact,
    }
    if decision["remat"]:
        def remat(*args, **kwargs):
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return remat, decision
    return fn, decision
