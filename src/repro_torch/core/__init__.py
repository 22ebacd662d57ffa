"""SERENITY core on PyTorch: memory-aware scheduling of irregularly wired
neural networks, executed in one arena on the card.

The planner is a copy of the JAX package's numpy planner (same names, same
integers); the executor runs plans on torch tensors through the CUDA arena
kernels.

Public API:

    Graph, Node, simulate_schedule          -- dataflow IR + footprint model
    graph_to_specs                          -- a graph back to the spec list
                                               Graph.build takes
    dp_schedule, brute_force_schedule       -- Algorithm 1 + branch-and-bound
                                               pruning (+ oracle for tests)
    pareto_schedule, oracle_frontier        -- width-W latency x memory
                                               frontier + its differential
                                               oracle (DESIGN.md §12)
    adaptive_budget_schedule                -- Algorithm 2
    partition, partition_hierarchy          -- divide & conquer (flat and
    find_separators                            nested segment tree)
    plan, PlanConfig, Plan                  -- THE planning entry point:
                                               rewrite [+ recompute] + order
                                               + arena in one call (Fig. 4)
    rewrite_graph, annotate_inplace         -- identity rewriting + in-place
    rematerialize                           -- recompute-clone expansion
    plan_arena, plan_arena_best             -- offset allocation policies
    plan_arena_regions                      -- resident-state + transient
                                               two-region serving layout
    plan_shared_arena, plan_coresidency     -- co-residency: K plans in one
                                               buffer (multi-tenant pool)
    simulate_traffic                        -- Belady off-chip traffic model
    execute, execute_plan, compile_plan     -- run a schedule on the planned
                                               arena (realized footprint)
    pack_buffers, unpack_buffer             -- real tensors in a uint8 arena
    trace_fn, fx_to_graph, schedule_fx      -- the graph bridge (fx_bridge):
    serenity_transform, compile_scheduled      a PyTorch function's aten ops
    analyze_fn, memory_aware_remat             reordered, and run through the
                                               planned arena on the card
    schedule, schedule_order                -- deprecated kwarg shims onto
                                               plan()/PlanConfig
"""

from repro_torch.core.allocator import (
    ArenaPlan,
    SharedArenaPlan,
    pin_transients,
    plan_arena,
    plan_arena_best,
    plan_arena_regions,
    plan_shared_arena,
    resident_bytes,
)
from repro_torch.core.budget import adaptive_budget_schedule
from repro_torch.core.executor import (
    ExecutionResult,
    ExecutorError,
    PlanProgram,
    RealizedTracker,
    compile_plan,
    execute_plan,
    pack_buffers,
    reference_fn,
    run_reference,
    unpack_buffer,
)
from repro_torch.core.fx_bridge import (
    FxScheduleReport,
    ScheduledProgram,
    analyze_fn,
    compile_scheduled,
    fx_config,
    fx_to_graph,
    memory_aware_remat,
    schedule_fx,
    serenity_transform,
    trace_fn,
)
from repro_torch.core.graph import (
    Graph,
    GraphError,
    Node,
    SimResult,
    graph_to_specs,
    simulate_schedule,
    simulate_steps,
)
from repro_torch.core.heuristics import (
    BASELINES,
    best_heuristic_schedule,
    dfs_schedule,
    greedy_schedule,
    kahn_schedule,
)
from repro_torch.core.ilp_oracle import (
    OracleError,
    oracle_frontier,
)
from repro_torch.core.partition import (
    PartitionNode,
    Segment,
    find_separators,
    partition,
    partition_hierarchy,
)
from repro_torch.core.plancache import (
    PlanCache,
    canonical_hash,
    default_cache,
    labeled_fingerprint,
    translate_order,
    wl_colors,
)
from repro_torch.core.rewriter import (
    FusedRegion,
    RecomputeReport,
    RewriteReport,
    annotate_inplace,
    fuse_alias_chains,
    graph_flops,
    node_flops,
    recompute_provenance,
    rematerialize,
    rewrite_graph,
)
from repro_torch.core.scheduler import (
    NoSolutionError,
    ParetoFrontier,
    ParetoPoint,
    ScheduleResult,
    SearchTimeout,
    brute_force_schedule,
    dp_schedule,
    node_costs,
    pareto_schedule,
    steps_makespan,
)
from repro_torch.core.serenity import (
    OrderResult,
    Plan,
    PlanConfig,
    SerenityResult,
    execute,
    plan,
    plan_coresidency,
    schedule,
    schedule_order,
)
from repro_torch.core.traffic import TrafficResult, simulate_traffic

__all__ = [
    "ArenaPlan",
    "BASELINES",
    "ExecutionResult",
    "ExecutorError",
    "FusedRegion",
    "FxScheduleReport",
    "Graph",
    "GraphError",
    "Node",
    "NoSolutionError",
    "OracleError",
    "OrderResult",
    "ParetoFrontier",
    "ParetoPoint",
    "PartitionNode",
    "Plan",
    "PlanCache",
    "PlanConfig",
    "PlanProgram",
    "RealizedTracker",
    "RecomputeReport",
    "RewriteReport",
    "ScheduledProgram",
    "ScheduleResult",
    "SearchTimeout",
    "Segment",
    "SerenityResult",
    "SharedArenaPlan",
    "SimResult",
    "TrafficResult",
    "adaptive_budget_schedule",
    "analyze_fn",
    "annotate_inplace",
    "best_heuristic_schedule",
    "brute_force_schedule",
    "canonical_hash",
    "compile_plan",
    "compile_scheduled",
    "default_cache",
    "dfs_schedule",
    "dp_schedule",
    "execute",
    "execute_plan",
    "find_separators",
    "fuse_alias_chains",
    "fx_config",
    "fx_to_graph",
    "graph_flops",
    "graph_to_specs",
    "greedy_schedule",
    "kahn_schedule",
    "labeled_fingerprint",
    "memory_aware_remat",
    "node_costs",
    "node_flops",
    "oracle_frontier",
    "pack_buffers",
    "pareto_schedule",
    "partition",
    "partition_hierarchy",
    "pin_transients",
    "plan",
    "plan_arena",
    "plan_arena_best",
    "plan_arena_regions",
    "plan_coresidency",
    "plan_shared_arena",
    "recompute_provenance",
    "reference_fn",
    "rematerialize",
    "resident_bytes",
    "rewrite_graph",
    "run_reference",
    "schedule",
    "schedule_fx",
    "schedule_order",
    "serenity_transform",
    "simulate_schedule",
    "simulate_steps",
    "simulate_traffic",
    "steps_makespan",
    "trace_fn",
    "translate_order",
    "unpack_buffer",
    "wl_colors",
]
