"""SERENITY end-to-end planning pipeline (paper Fig. 4) and executor.

    graph  ->  [identity graph rewriting]  ->  [rematerialization]
           ->  divide-and-conquer  ->  per-segment soft-budgeted DP
           ->  combine  ->  (peak footprint, arena plan, schedule)
           ->  execute: run the schedule against the planned arena

The public planning surface is one function and one config object:

    ``plan(graph, PlanConfig(...)) -> Plan``

``PlanConfig`` is a frozen dataclass holding every planning knob (rewrite,
recompute, scheduler choice, DP engine/budgets, arena policy); ``Plan``
bundles the scheduled graph, order, peaks, arena offsets and reports.
``execute`` realizes a plan in one arena tensor on the card (or on the CPU
when asked) and measures that the footprint the device reserves equals the
planned bytes (DESIGN.md §6).

The pre-``PlanConfig`` entry points (``schedule``, ``schedule_order``,
``plan_coresidency`` with loose kwargs) keep working as deprecation shims:
each warns ``DeprecationWarning`` once per process and maps its kwargs onto
the equivalent ``PlanConfig``, producing an identical plan (and hitting the
same cache entries).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Sequence

from repro_torch.core.allocator import (
    ArenaPlan,
    SharedArenaPlan,
    plan_arena,
    plan_arena_best,
    plan_arena_regions,
    plan_shared_arena,
)
from repro_torch.core.budget import BudgetSearchStats, adaptive_budget_schedule
from repro_torch.core.executor import ExecutionResult, ExecutorError, execute_plan
from repro_torch.core.graph import Graph, simulate_schedule
from repro_torch.core.heuristics import BASELINES, kahn_schedule
from repro_torch.core.partition import Segment, partition_hierarchy
from repro_torch.core.plancache import (
    PlanCache,
    resolve as _resolve_cache,
    translate_order,
)
from repro_torch.core.rewriter import (
    RecomputeReport,
    RewriteReport,
    annotate_inplace,
    rematerialize,
    rewrite_graph,
)
from repro_torch.core.graph import simulate_steps
from repro_torch.core.scheduler import (
    ParetoFrontier,
    ScheduleResult,
    SearchTimeout,
    dp_schedule,
    node_costs,
    pareto_schedule,
)


_SCHEDULERS = ("dp", "kahn")
_ON_TIMEOUT = ("adaptive", "raise")
_OBJECTIVES = ("peak", "pareto")


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """Every planning knob, in one frozen, hashable, serializable object.

    Field groups mirror the pipeline stages (DESIGN.md §10):

    rewriting
      ``rewrite``: apply the paper's identity graph rewrites (partial convs,
      concat views, fused-proj distribution).  ``inplace``: additionally
      mark in-place-eligible elementwise ops so unary chains share one
      buffer (applied after rematerialization — cloning changes consumer
      counts and hence in-place eligibility).

    rematerialization
      ``recompute``: expand the graph with recompute clones
      (:func:`~repro_torch.core.rewriter.rematerialize`) before ordering, trading
      up to ``flops_budget``x surrogate FLOPs for a lower schedulable peak.
      ``recompute_beam`` / ``recompute_rounds`` / ``recompute_quota`` bound
      the clone-set beam search (states kept per round / beam rounds / DP
      state quota per candidate evaluation).

    ordering
      ``scheduler``: ``'dp'`` runs the hierarchical exact pipeline;
      ``'kahn'`` takes the memory-greedy topological order outright — the
      right choice for graphs the DP models badly (e.g. serving decode
      state: dozens of isolated persistent buffers make the DP's bitmask
      space explode with nothing to gain).  The remaining knobs parameterize
      the DP: divide and conquer, the Algorithm 2 soft-budget fallback and
      its ``state_quota``, the ``exact_threshold`` below which cells skip
      the meta-search, the DP ``engine``, branch-and-bound (``bnb``), an
      optional hard peak budget ``tau`` (bytes), and the quota-exhaustion
      policy ``on_timeout`` (``'adaptive'`` or ``'raise'``).

    multi-objective
      ``objective='pareto'`` switches ordering to the two-objective
      time-slot DP (:func:`~repro_torch.core.scheduler.pareto_schedule`): up to
      ``max_width`` ready ops execute per step, the full latency-vs-peak
      frontier lands in ``Plan.schedule_frontier``, and the realized plan
      is the min-peak point whose makespan fits ``latency_budget`` (bytes
      budget still via ``tau``).  Requires ``scheduler='dp'``;
      ``max_width`` / ``latency_budget`` are rejected under the default
      ``objective='peak'`` so a serial config can never silently mean two
      things.

    arena
      ``arena_policy``: offset-allocator placement policy (``'best'`` races
      them all).  ``resident``: node ids pinned live across the whole
      schedule at the bottom of the arena
      (:func:`~repro_torch.core.allocator.plan_arena_regions` layout — the
      serving decode-state shape).

    reporting
      ``compute_baselines``: also evaluate the heuristic baselines on the
      final graph.
    """

    # -- graph rewriting --
    rewrite: bool = True
    inplace: bool = True
    # -- rematerialization --
    recompute: bool = False
    flops_budget: float = 1.3
    recompute_beam: int = 4
    recompute_rounds: int = 6
    recompute_quota: int = 800
    # -- ordering --
    scheduler: str = "dp"
    divide_and_conquer: bool = True
    adaptive_budget: bool = True
    state_quota: int | None = 20_000
    exact_threshold: int = 18
    engine: str = "auto"
    bnb: bool = True
    tau: int | None = None
    on_timeout: str = "adaptive"
    # -- multi-objective (latency x memory, DESIGN.md §12) --
    objective: str = "peak"
    max_width: int = 1
    latency_budget: int | None = None
    # -- arena --
    arena_policy: str = "best"
    resident: tuple[int, ...] = ()
    # -- reporting --
    compute_baselines: bool = True

    def __post_init__(self):
        if self.scheduler not in _SCHEDULERS:
            raise ValueError(
                f"PlanConfig.scheduler must be one of {_SCHEDULERS}, "
                f"got {self.scheduler!r}")
        if self.on_timeout not in _ON_TIMEOUT:
            raise ValueError(
                f"PlanConfig.on_timeout must be one of {_ON_TIMEOUT}, "
                f"got {self.on_timeout!r}")
        if self.flops_budget < 1.0:
            raise ValueError("PlanConfig.flops_budget must be >= 1.0 "
                             f"(got {self.flops_budget})")
        if self.objective not in _OBJECTIVES:
            raise ValueError(
                f"PlanConfig.objective must be one of {_OBJECTIVES}, "
                f"got {self.objective!r}")
        if self.max_width < 1:
            raise ValueError("PlanConfig.max_width must be >= 1 "
                             f"(got {self.max_width})")
        if self.objective == "pareto":
            if self.scheduler != "dp":
                raise ValueError(
                    "PlanConfig.objective='pareto' requires scheduler='dp' "
                    f"(got {self.scheduler!r})")
        elif self.max_width != 1 or self.latency_budget is not None:
            raise ValueError(
                "PlanConfig.max_width/latency_budget only apply under "
                "objective='pareto'")
        object.__setattr__(self, "resident", tuple(self.resident))

    def replace(self, **changes) -> "PlanConfig":
        """A copy with the given fields changed."""
        return dataclasses.replace(self, **changes)

    def cache_key(self) -> tuple:
        """Name-keyed serialized form for plan-cache addressing.

        Every field appears as a ``(name, value)`` pair, so adding a config
        field changes the key *shape* (clean cache miss) instead of
        silently aliasing entries the way positional option tuples did.
        """
        return tuple(sorted(dataclasses.asdict(self).items()))


@dataclasses.dataclass
class SerenityResult:
    """A complete plan: the scheduled graph, its order, peaks and arena.

    ``Plan`` is the preferred alias; :func:`plan` is the entry point that
    produces it.
    """

    graph: Graph                       # possibly rewritten graph actually scheduled
    order: list[int]
    peak_bytes: int                    # paper's footprint model (no allocator)
    arena: ArenaPlan                   # footprint through the linear allocator
    segments: list[Segment]
    rewrite_report: RewriteReport | None
    budget_stats: list[BudgetSearchStats]
    wall_time_s: float
    baseline_peaks: dict[str, int]     # heuristic peaks on the same graph
    exact: bool = True                 # every segment solved by the exact DP
    n_states_expanded: int = 0         # DP transitions summed over segments
    seg_cache_hits: int = 0            # segments replayed from the plan cache
    config: "PlanConfig | None" = None           # the config that built this
    recompute_report: "RecomputeReport | None" = None
    steps: "tuple[tuple[int, ...], ...] | None" = None  # width-W time slots
                                       # (objective='pareto'; None = serial)
    makespan: int = 0                  # surrogate-cost makespan of the order
    schedule_frontier: "ParetoFrontier | None" = None   # latency-vs-peak
                                       # frontier (objective='pareto' only)

    @property
    def arena_bytes(self) -> int:
        return self.arena.arena_bytes

    @property
    def pareto_frontier(self) -> tuple[tuple[float, int, int], ...]:
        """Recompute peak-vs-FLOPs frontier: (flops_ratio, peak_bytes,
        n_clones) points, or ``()`` when planned without recompute."""
        if self.recompute_report is None:
            return ()
        return self.recompute_report.frontier

    @property
    def latency_frontier(self) -> tuple[tuple[int, int], ...]:
        """Latency-vs-peak frontier: (makespan, peak_bytes) points sorted
        by makespan, or ``()`` when planned without ``objective='pareto'``.
        Distinct from :attr:`pareto_frontier`, the recompute FLOPs-vs-peak
        trade-off."""
        if self.schedule_frontier is None:
            return ()
        return self.schedule_frontier.pairs()

    @property
    def flops_ratio(self) -> float:
        """Executed/base surrogate-FLOPs ratio (1.0 = no recompute)."""
        if self.recompute_report is None:
            return 1.0
        return self.recompute_report.flops_ratio


Plan = SerenityResult


@dataclasses.dataclass
class SegmentPlan:
    """Cached DP result for one partition cell (anonymized subgraph)."""

    graph: Graph                       # the anonymized segment subgraph
    preplaced: tuple[int, ...]         # boundary ids within that subgraph
    result: ScheduleResult


@dataclasses.dataclass
class OrderResult:
    """A memory-optimal order for a whole graph, segment by segment."""

    order: list[int]
    exact: bool
    n_states_expanded: int
    n_signatures: int
    segments: list[Segment]
    seg_cache_hits: int
    budget_stats: list[BudgetSearchStats]


# Entry points that already delivered their DeprecationWarning this process
# (one warning per entry point, not per call).  Tests reset via
# _reset_deprecation_warnings().
_DEPRECATION_WARNED: set[str] = set()


def _warn_deprecated(entry: str, replacement: str) -> None:
    if entry in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(entry)
    warnings.warn(
        f"{entry} is deprecated; use {replacement}",
        DeprecationWarning, stacklevel=3)


def _reset_deprecation_warnings() -> None:
    """Forget which entry points already warned (test hook)."""
    _DEPRECATION_WARNED.clear()


def _order_graph(g: Graph, config: PlanConfig,
                 cache: PlanCache | None) -> OrderResult:
    """Hierarchically decompose ``g`` and DP-schedule each cell once.

    The nested segment tree (:func:`repro_torch.core.partition.partition_hierarchy`)
    reduces the graph to leaf cells; each leaf's *anonymized* subgraph is
    DP-scheduled with the branch-and-bound search and memoized in the plan
    cache, so structurally identical cells — stacked RandWire/DARTS stages
    repeat — schedule once and replay (``seg_cache_hits``).  A relabeled
    isomorphic cell additionally tries the cache's canonical (WL) tier and
    rewrites the stored order through the color bijection
    (:func:`repro_torch.core.plancache.translate_order`).

    Large cells run the branch-and-bound DP under ``config.state_quota``;
    ``config.on_timeout`` picks the quota-exhaustion policy: ``'adaptive'``
    falls back to the Algorithm 2 budget meta-search — and, if even that
    capitulates to a heuristic order, to a bounded per-cell beam, keeping
    the better of the two inexact orders — while ``'raise'`` propagates
    :class:`~repro_torch.core.scheduler.SearchTimeout` to the caller.  ``exact``
    reports whether every cell was solved exactly.  When ``cache`` is None
    an ephemeral per-call cache still provides in-run cell reuse.
    """
    if config.divide_and_conquer:
        leaves = partition_hierarchy(g).leaves()
        segments = [Segment(node_ids=list(lf.node_ids),
                            boundary_in=list(lf.boundary_in))
                    for lf in leaves]
    else:
        segments = [Segment(node_ids=g.topo_order(), boundary_in=[])]

    engine, state_quota = config.engine, config.state_quota
    seg_cache = cache if cache is not None else PlanCache(capacity=64)
    order: list[int] = []
    budget_stats: list[BudgetSearchStats] = []
    exact = True
    expanded = 0
    n_signatures = 0
    hits = 0
    for seg in segments:
        sub_ids = sorted(set(seg.node_ids) | set(seg.boundary_in))
        sub, idmap = g.induced_subgraph(sub_ids, anonymize=True)
        inv = {v: k for k, v in idmap.items()}
        pre = tuple(sorted(idmap[b] for b in seg.boundary_in))
        opts = ("dp_segment", pre, engine, state_quota,
                config.exact_threshold, config.adaptive_budget, config.bnb,
                config.tau)
        seg_plan = seg_cache.get(sub, opts)
        if seg_plan is None:
            iso = seg_cache.get_canonical(sub, opts)
            if isinstance(iso, SegmentPlan):
                k = len(iso.result.order)
                translated = translate_order(
                    iso.graph, sub,
                    list(iso.result.order) + list(iso.preplaced))
                if translated is not None and \
                        sorted(translated[k:]) == sorted(pre):
                    seg_plan = SegmentPlan(
                        graph=sub, preplaced=pre,
                        result=dataclasses.replace(
                            iso.result, order=translated[:k]),
                    )
                    seg_cache.put(sub, opts, seg_plan)
        if seg_plan is not None:
            hits += 1
            res = seg_plan.result
            searched = False
        else:
            searched = True
            n_free = len(sub) - len(pre)
            if n_free <= config.exact_threshold or not config.adaptive_budget:
                res = dp_schedule(sub, preplaced=pre, engine=engine,
                                  bnb=config.bnb, budget=config.tau)
            else:
                try:
                    res = dp_schedule(sub, preplaced=pre, engine=engine,
                                      state_quota=state_quota,
                                      bnb=config.bnb, budget=config.tau)
                except SearchTimeout:
                    if config.on_timeout == "raise":
                        raise
                    # Algorithm 2 fallback: budget meta-search with quota
                    # escalation (terminates; may capitulate to a heuristic
                    # order, which clears the `exact` flag)
                    res, stats = adaptive_budget_schedule(
                        sub, state_quota=state_quota, preplaced=pre,
                        engine=engine,
                    )
                    budget_stats.append(stats)
                    if not res.exact:
                        # meta-search capitulated to a heuristic order: a
                        # bounded beam usually does better — keep the lower
                        # peak (both are inexact)
                        beam = dp_schedule(sub, preplaced=pre, engine=engine,
                                           state_quota=state_quota,
                                           on_quota="beam")
                        if beam.peak_bytes < res.peak_bytes:
                            res = beam
            seg_cache.put(sub, opts, SegmentPlan(sub, pre, res))
        order.extend(inv[u] for u in res.order)
        exact = exact and res.exact
        if searched:          # replayed cells did no search work
            expanded += res.n_states_expanded
            n_signatures += res.n_signatures
    return OrderResult(
        order=order,
        exact=exact,
        n_states_expanded=expanded,
        n_signatures=n_signatures,
        segments=segments,
        seg_cache_hits=hits,
        budget_stats=budget_stats,
    )


def schedule_order(
    g: Graph,
    *,
    divide_and_conquer: bool = True,
    adaptive_budget: bool = True,
    state_quota: int | None = 20_000,
    exact_threshold: int = 18,
    engine: str = "auto",
    cache: PlanCache | None = None,
    on_timeout: str = "adaptive",
) -> OrderResult:
    """Deprecated shim: order ``g`` with kwargs instead of a `PlanConfig`.

    Maps its kwargs onto :class:`PlanConfig` and runs the same hierarchical
    ordering pipeline :func:`plan` uses.  Warns ``DeprecationWarning`` once
    per process.
    """
    _warn_deprecated(
        "serenity.schedule_order(**kwargs)",
        "serenity.plan(graph, PlanConfig(...)) and Plan.order")
    config = PlanConfig(
        divide_and_conquer=divide_and_conquer,
        adaptive_budget=adaptive_budget,
        state_quota=state_quota,
        exact_threshold=exact_threshold,
        engine=engine,
        on_timeout=on_timeout,
    )
    return _order_graph(g, config, cache)


def plan(
    g: Graph,
    config: PlanConfig | None = None,
    *,
    order: Sequence[int] | None = None,
    cache: "PlanCache | bool | None" = True,
) -> Plan:
    """Run the full SERENITY planning pipeline on graph ``g``.

    The one planning entry point: rewrite (+ optional rematerialization) →
    order (hierarchical exact DP, or the Kahn heuristic, per
    ``config.scheduler``) → arena offsets, bundled into a single
    :class:`Plan`.

    Args:
      g: the dataflow graph to plan (node sizes in *bytes*).
      config: a :class:`PlanConfig`; ``None`` means ``PlanConfig()`` (all
        defaults: rewrite + in-place + hierarchical exact DP + best-of
        arena policies, no recompute).
      order: pre-computed schedule of ``g`` to pack an arena for, skipping
        the rewrite and ordering stages entirely (the resulting plan's
        ``exact`` flag is False — nothing was proven about the order).
      cache: content-addressed plan memoization.  ``True`` (default) uses
        the process-wide :class:`~repro_torch.core.plancache.PlanCache`; pass a
        :class:`PlanCache` to control capacity/disk placement, or ``False``
        to always recompute.  Keys derive from ``config.cache_key()`` —
        name-keyed, so the legacy shims and direct calls with equivalent
        configs hit the same entries.  A hit returns the cold run's
        :class:`Plan` zero-copy — treat cached plans as immutable.

    Returns:
      A :class:`Plan`: the (possibly rewritten/expanded) graph actually
      scheduled, the chosen ``order``, ``peak_bytes`` (liveness-model peak,
      bytes), the packed ``arena`` plan (``arena_bytes`` = bytes a device
      must reserve), segments, rewrite/recompute/budget/baseline reports,
      the originating ``config`` and the planning wall time in seconds.
      With ``config.recompute``, ``plan.pareto_frontier`` holds the
      peak-vs-FLOPs frontier and ``plan.graph`` contains the executable
      recompute clones of its lowest-peak point.
    """
    if config is None:
        config = PlanConfig()
    if order is not None and config.objective == "pareto":
        raise ValueError("plan: a pre-computed order cannot be combined "
                         "with objective='pareto' (the frontier chooses "
                         "the order)")
    pc = _resolve_cache(cache)
    cache_opts = ("serenity.plan", config.cache_key())
    if order is not None:
        order = list(order)
        cache_opts += (("order", tuple(order)),)
    if pc is not None:
        hit = pc.get(g, cache_opts)
        if hit is not None:
            return hit

    t0 = time.perf_counter()
    g_in = g                      # cache key addresses the pre-rewrite graph
    rewrite_report: RewriteReport | None = None
    recompute_report: RecomputeReport | None = None
    if order is None:
        if config.rewrite:
            g, rewrite_report = rewrite_graph(g)
        if config.recompute:
            g, recompute_report = rematerialize(
                g,
                flops_budget=config.flops_budget,
                beam_width=config.recompute_beam,
                max_rounds=config.recompute_rounds,
                eval_quota=config.recompute_quota,
                inplace=config.inplace,
            )
        # in-place marking runs after cloning: a recompute clone changes its
        # original's consumer count, which changes in-place eligibility
        if config.inplace and (config.rewrite or config.recompute):
            g, n_inplace = annotate_inplace(g)
            if rewrite_report is not None:
                rewrite_report.n_inplace = n_inplace

    steps: "tuple[tuple[int, ...], ...] | None" = None
    frontier: ParetoFrontier | None = None
    if order is not None:
        ores = OrderResult(order=order, exact=False, n_states_expanded=0,
                           n_signatures=0, segments=[], seg_cache_hits=0,
                           budget_stats=[])
    elif config.objective == "pareto":
        # direct two-objective DP on the whole (rewritten) graph: the
        # frontier's serial endpoint is seeded from the exact serial DP, so
        # it equals the hierarchical pipeline's peak even if the Pareto
        # level search gets beam-trimmed (DESIGN.md §12)
        frontier = pareto_schedule(
            g,
            max_width=config.max_width,
            latency_budget=config.latency_budget,
            budget=config.tau,
            state_quota=config.state_quota,
            on_quota="beam" if config.on_timeout == "adaptive" else "raise",
        )
        point = frontier.best_under(config.latency_budget)
        steps = point.steps
        ores = OrderResult(order=point.order, exact=frontier.exact,
                           n_states_expanded=frontier.n_states_expanded,
                           n_signatures=frontier.n_signatures, segments=[],
                           seg_cache_hits=0, budget_stats=[])
    elif config.scheduler == "kahn":
        ores = OrderResult(order=kahn_schedule(g).order, exact=False,
                           n_states_expanded=0, n_signatures=0, segments=[],
                           seg_cache_hits=0, budget_stats=[])
    else:
        ores = _order_graph(g, config, pc)

    if steps is not None:
        sim = simulate_steps(g, steps)
    else:
        sim = simulate_schedule(g, ores.order)
    if config.resident:
        arena = plan_arena_regions(g, ores.order,
                                   resident=list(config.resident),
                                   steps=steps)
    elif config.arena_policy == "best":
        arena = plan_arena_best(g, ores.order, steps=steps)
    else:
        arena = plan_arena(g, ores.order, policy=config.arena_policy,
                           steps=steps)
    baselines: dict[str, int] = {}
    if config.compute_baselines:
        for name, fn in BASELINES.items():
            baselines[name] = fn(g).peak_bytes
    costs = node_costs(g)
    if steps is not None:
        makespan = sum(max(costs[u] for u in st) for st in steps if st)
    else:
        makespan = sum(costs[u] for u in ores.order)
    result = Plan(
        graph=g,
        order=ores.order,
        peak_bytes=sim.peak_bytes,
        arena=arena,
        segments=ores.segments,
        rewrite_report=rewrite_report,
        budget_stats=ores.budget_stats,
        wall_time_s=time.perf_counter() - t0,
        baseline_peaks=baselines,
        exact=ores.exact,
        n_states_expanded=ores.n_states_expanded,
        seg_cache_hits=ores.seg_cache_hits,
        config=config,
        recompute_report=recompute_report,
        steps=steps,
        makespan=makespan,
        schedule_frontier=frontier,
    )
    if pc is not None:
        pc.put(g_in, cache_opts, result)
    return result


def schedule(
    g: Graph,
    *,
    rewrite: bool = True,
    inplace: bool = True,
    divide_and_conquer: bool = True,
    adaptive_budget: bool = True,
    state_quota: int = 20_000,
    exact_threshold: int = 18,
    compute_baselines: bool = True,
    engine: str = "auto",
    cache: "PlanCache | bool | None" = True,
) -> SerenityResult:
    """Deprecated shim: the pre-``PlanConfig`` pipeline entry point.

    Maps its kwargs onto the equivalent :class:`PlanConfig` and calls
    :func:`plan` — the result is identical (and hits the same cache
    entries).  Warns ``DeprecationWarning`` once per process.
    """
    _warn_deprecated("serenity.schedule(**kwargs)",
                     "serenity.plan(graph, PlanConfig(...))")
    return plan(g, _legacy_schedule_config(
        rewrite=rewrite, inplace=inplace,
        divide_and_conquer=divide_and_conquer,
        adaptive_budget=adaptive_budget, state_quota=state_quota,
        exact_threshold=exact_threshold,
        compute_baselines=compute_baselines, engine=engine,
    ), cache=cache)


def _legacy_schedule_config(**kwargs) -> PlanConfig:
    """The ``PlanConfig`` that the kwargs of a legacy ``schedule`` call map
    onto."""
    return PlanConfig(**kwargs)


# `execute` has a parameter named `plan` (the arena plan to realize), so the
# planning function needs an unshadowed module-level alias there.
_plan = plan


def plan_coresidency(
    graphs: Sequence[Graph],
    budget: int | None = None,
    *,
    serialize: bool = True,
    config: PlanConfig | None = None,
    cache: "PlanCache | bool | None" = True,
    **schedule_kw,
) -> tuple[SharedArenaPlan, list[SerenityResult]]:
    """Plan each graph, then co-plan all their arenas into one buffer.

    The multi-tenant composition of the pipeline (DESIGN.md §9): each graph
    gets its own optimal schedule and standalone arena plan via
    :func:`plan`, and :func:`~repro_torch.core.allocator.plan_shared_arena`
    overlaps the members' non-concurrent slack inside one joint buffer.
    Each returned ``members[i]`` plan can execute against the shared buffer
    directly (``execute_plan(res.graph, res.order, shared.members[i],
    arena=buf)``).

    Legacy ``schedule``-style kwargs are accepted as a deprecation shim
    (warns once) and map onto ``config``; passing both is an error.

    Returns ``(shared_plan, per-graph Plans)``; callers check
    ``shared_plan.fits(budget)`` for admission decisions.
    """
    if schedule_kw:
        if config is not None:
            raise TypeError("plan_coresidency: pass either config= or "
                            "legacy schedule kwargs, not both")
        _warn_deprecated(
            "plan_coresidency(**schedule_kwargs)",
            "plan_coresidency(graphs, budget, config=PlanConfig(...))")
        config = _legacy_schedule_config(**schedule_kw)
    results = [plan(g, config, cache=cache) for g in graphs]
    shared = plan_shared_arena([r.arena for r in results], budget,
                               serialize=serialize)
    return shared, results


def execute(
    g: Graph,
    inputs=None,
    plan: ArenaPlan | None = None,
    *,
    order: Sequence[int] | None = None,
    impl: str = "auto",
    device=None,
    arena=None,
    strict: bool = True,
    fuse: bool = False,
    steps: "Sequence[Sequence[int]] | None" = None,
    config: PlanConfig | None = None,
    cache: "PlanCache | bool | None" = True,
    **schedule_kw,
) -> ExecutionResult:
    """Schedule (if needed) and run ``g`` on the planned arena.

    The plan→execution closing move (DESIGN.md §6): every intermediate
    tensor lives as a slice of one arena tensor at its
    :class:`~repro_torch.core.allocator.ArenaPlan` byte offset, and execution
    *measures* the realized footprint against the planned one.

    Args:
      g: graph to run.  When ``plan`` is ``None`` the full pipeline
        (:func:`schedule`, including rewriting) runs first and the rewritten
        graph is executed; when a ``plan`` is supplied, ``g`` must be the
        exact graph the plan was built from and ``order`` its schedule.
      inputs: values for the graph's input nodes — ``{name: array}``,
        ``{node_id: array}`` or a sequence in input-node order; flattened to
        float32.  Missing inputs get deterministic defaults.
      plan: an :class:`ArenaPlan` to realize (skips scheduling).
      order: the schedule ``plan`` was built from (required with ``plan``).
      impl / device / arena / strict / fuse: forwarded to
        :func:`repro_torch.core.executor.execute_plan` — arena-op dispatch
        (the CUDA kernels on the card, the plain versions on the CPU), the
        device (``None``: the card; raises when CUDA is absent), an
        optional float32 arena written in place, the realized-vs-planned
        assertion, and fused alias-chain execution (DESIGN.md §11).
      steps: width-W time slots the supplied ``plan`` was packed with
        (``Plan.steps`` of a pareto plan); ignored when planning here —
        the fresh plan's own steps are used.
      config / cache: forwarded to :func:`plan` when planning here.
      **schedule_kw: legacy ``schedule``-style kwargs (deprecation shim,
        warns once); mapped onto ``config`` — passing both is an error.

    Returns:
      :class:`~repro_torch.core.executor.ExecutionResult` with the output values
      (flat float32, keyed by output-node name) and the measured
      ``realized_peak_bytes`` / ``realized_arena_bytes`` (both in bytes,
      asserted equal to the plan's ``peak_bytes`` / ``arena_bytes`` under
      ``strict``).
    """
    if plan is None:
        if schedule_kw:
            if config is not None:
                raise TypeError("execute: pass either config= or legacy "
                                "schedule kwargs, not both")
            _warn_deprecated(
                "execute(**schedule_kwargs)",
                "execute(g, config=PlanConfig(...))")
            config = _legacy_schedule_config(**schedule_kw)
        res = _plan(g, config, cache=cache)
        g, order, plan = res.graph, res.order, res.arena
        steps = res.steps  # pareto plans carry their width-W slots
    elif order is None:
        raise ExecutorError("execute: `order` is required when `plan` is "
                            "supplied (the schedule the plan was built from)")
    return execute_plan(g, order, plan, inputs, impl=impl, device=device,
                        arena=arena, strict=strict, fuse=fuse, steps=steps)
