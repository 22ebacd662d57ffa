"""Quickstart on the PyTorch/CUDA port: SERENITY in 60 seconds.

    PYTHONPATH=src python examples/quickstart_torch.py               # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # no card

1. Schedule an irregularly wired cell for minimal peak activation memory.
2. Rewrite concat+conv patterns and re-schedule (paper Fig. 9).
3. Execute the schedule on the planned arena: every intermediate is a slice
   of one buffer, and the realized footprint is *measured* equal to the plan.
4. Apply the same scheduler to a PyTorch function's aten graph, and run the
   reordered program through one planned uint8 arena (the arena kernels on
   the card).
"""

import argparse

import torch

from repro_torch.core import PlanConfig, compile_scheduled, execute, plan
from repro_torch.core.executor import resolve_device
from repro_torch.graphs import swiftnet_cell
from repro_torch.graphs.programs import branchy_residual


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' without "
                         "one)")
    dev = resolve_device(ap.parse_args(argv).device)

    # -- 1/2: the paper's pipeline on an edge-style NAS cell ----------------
    g = swiftnet_cell("A")
    plain = plan(g, PlanConfig(rewrite=False))
    rew = plan(g, PlanConfig(rewrite=True))
    kahn = plain.baseline_peaks["kahn"]
    print(f"SwiftNet cell A ({len(g)} nodes)")
    print(f"  TFLite-order peak : {kahn/1024:8.1f} KB")
    print(f"  SERENITY schedule : {plain.peak_bytes/1024:8.1f} KB "
          f"({kahn/plain.peak_bytes:.2f}x)")
    print(f"  + graph rewriting : {rew.peak_bytes/1024:8.1f} KB "
          f"({kahn/rew.peak_bytes:.2f}x)")
    print(f"  arena (allocator) : {rew.arena_bytes/1024:8.1f} KB")

    # -- 3: run the schedule against the planned arena ----------------------
    ex = execute(rew.graph, inputs=None, plan=rew.arena, order=rew.order,
                 device=dev)
    print(f"  executed on arena : realized peak "
          f"{ex.realized_peak_bytes/1024:8.1f} KB "
          f"(== planned: {ex.realized_matches_plan})")

    # -- 4: the same optimization on a PyTorch function ----------------------
    fn = compile_scheduled(branchy_residual, device=dev)
    x = torch.ones((64, 128), device=dev)
    y = fn(x)
    same = torch.allclose(y, branchy_residual(x), rtol=1e-5, atol=1e-5)
    r = fn.report
    print("\naten-graph scheduling (same algorithm, one level down):")
    print(f"  {r.n_eqns} ops; traced-order live peak "
          f"{r.original_peak/1024:.0f} KB -> {r.optimal_peak/1024:.0f} KB "
          f"({r.reduction_vs_original:.2f}x); arena {r.arena_bytes/1024:.0f}"
          f" KB, realized == planned: {r.realized_matches_plan}; "
          f"{r.n_arena_writes} arena writes and {r.n_arena_reads} reads a "
          f"call; output preserved: {same}")


if __name__ == "__main__":
    main()
