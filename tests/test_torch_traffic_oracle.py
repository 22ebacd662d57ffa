"""The port's off-chip traffic model and Pareto oracle against the JAX
package's: the same integers.

``simulate_traffic`` (Belady, paper Fig. 11) runs the DP, Kahn and traced
orders of every paper cell the port carries over a sweep of capacities
that includes the DP peak, where the DP order's traffic is 0; each
``TrafficResult`` equals ``repro``'s.  ``oracle_frontier`` with the
suffix-enumeration fallback equals ``repro``'s on the small graphs of
``tests/test_differential_pipeline.py`` (and the port's own
``pareto_schedule``).  The port has no ILP leg: without ``pulp``
``repro``'s ``solver="auto"`` takes the same enumeration, and both raise
``OracleError`` past ``max_nodes``.
"""

import pytest

torch = pytest.importorskip("torch")

import repro.core as rc  # noqa: E402
import repro.graphs as rg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.graphs as tg  # noqa: E402
from test_differential_pipeline import random_pipeline_graph  # noqa: E402

CELLS = sorted(tg.BENCHMARK_GRAPHS)


def _fields(r):
    return (r.read_bytes, r.write_bytes, r.weight_read_bytes,
            r.fits_entirely, r.total_bytes)


@pytest.mark.parametrize("name", CELLS)
def test_traffic_equal_to_repro(name):
    gt, gj = tg.BENCHMARK_GRAPHS[name](), rg.BENCHMARK_GRAPHS[name]()
    dp = tc.plan(gt, tc.PlanConfig(rewrite=False))
    kahn = tc.kahn_schedule(gt)
    orders = {"dp": list(dp.order), "kahn": list(kahn.order),
              "traced": list(range(len(gt)))}
    peak = dp.peak_bytes
    caps = sorted({peak, peak // 2, peak // 4, 3 * peak // 4,
                   kahn.peak_bytes, 2 * kahn.peak_bytes,
                   max(gt.sizes) + 1})
    spilled = 0
    for tag, order in orders.items():
        for cap in caps:
            for weights in (True, False):
                t = tc.simulate_traffic(gt, order, cap,
                                        include_weights=weights)
                j = rc.simulate_traffic(gj, order, cap,
                                        include_weights=weights)
                assert _fields(t) == _fields(j), (name, tag, cap, weights)
                spilled += t.write_bytes > 0
    assert spilled, f"{name}: no capacity of the sweep spills"
    # the paper's "eradicated" case: at the DP peak the DP order spills
    # nothing
    r = tc.simulate_traffic(gt, orders["dp"], peak, include_weights=False)
    assert r.total_bytes == 0 and r.fits_entirely, name


def _small_graphs():
    out = []
    for seed in range(40):
        gj = random_pipeline_graph(seed, max_nodes=8)
        if len(gj) <= 10:
            out.append((seed, gj))
    return out[:8]


def test_fallback_frontier_equal_to_repro():
    graphs = _small_graphs()
    assert len(graphs) >= 5
    for seed, gj in graphs:
        gt = tc.Graph.build(tc.graph_to_specs(gj), gj.name)
        for w in (1, 2, 3):
            want = rc.oracle_frontier(gj, max_width=w, solver="fallback")
            got = tc.oracle_frontier(gt, max_width=w)
            assert got == want, (seed, w)
            assert tc.pareto_schedule(gt, max_width=w).pairs() == got, \
                (seed, w)


def test_pulp_raises_in_both():
    """Without pulp ``repro``'s ILP leg raises and its ``'auto'`` is the
    enumeration the port keeps; both refuse a graph past ``max_nodes``."""
    seed, gj = _small_graphs()[0]
    gt = tc.Graph.build(tc.graph_to_specs(gj), gj.name)
    assert rc.has_ilp_solver() is False
    with pytest.raises(rc.OracleError, match="ilp"):
        rc.oracle_frontier(gj, max_width=2, solver="pulp")
    assert tc.oracle_frontier(gt, max_width=2, latency_budget=10**9) \
        == rc.oracle_frontier(gj, max_width=2)
    with pytest.raises(rc.OracleError, match="max_nodes"):
        rc.oracle_frontier(rg.swiftnet_cell("A"), max_width=2,
                           solver="fallback")
    with pytest.raises(tc.OracleError, match="max_nodes"):
        tc.oracle_frontier(tg.swiftnet_cell("A"), max_width=2)
