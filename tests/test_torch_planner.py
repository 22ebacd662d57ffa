"""The port's planner against the JAX package's: the same integers.

Both packages plan the same graphs (the paper cells, the full networks and a
seeded corpus rebuilt in both from one spec list); the order, the peak and
arena bytes and every node's arena offset must be equal, for every DP engine
and with rewriting on and off.  Also: the port's networkx-free Watts-Strogatz
generator gives networkx's edge set, and the two plan caches keep apart on
disk.
"""

import itertools

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP pool on 150k-element ops would take the cores from the others
torch.set_num_threads(1)

import networkx as nx  # noqa: E402

import repro.core as rc  # noqa: E402
import repro.core.plancache as rc_cache  # noqa: E402
import repro.graphs as rg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.core.plancache as tc_cache  # noqa: E402
import repro_torch.graphs as tg  # noqa: E402
from repro_torch.graphs.randwire import connected_watts_strogatz_edges  # noqa: E402
from test_differential_pipeline import random_pipeline_graph  # noqa: E402

ENGINES = ("python", "numpy", "auto")
GRAPHS = sorted({**rg.BENCHMARK_GRAPHS, **rg.FULL_NETWORKS})


def _assert_same_plan(pj, pt, what):
    assert list(pt.order) == list(pj.order), what
    assert pt.peak_bytes == pj.peak_bytes, what
    assert pt.arena_bytes == pj.arena_bytes, what
    assert len(pt.graph) == len(pj.graph), what
    for u in range(len(pj.graph)):
        assert pt.arena.offset_of(u) == pj.arena.offset_of(u), (what, u)


def test_paper_graphs_are_the_same_in_both_packages():
    for name in GRAPHS:
        gj = {**rg.BENCHMARK_GRAPHS, **rg.FULL_NETWORKS}[name]()
        gt = {**tg.BENCHMARK_GRAPHS, **tg.FULL_NETWORKS}[name]()
        assert tc.graph_to_specs(gt) == tc.graph_to_specs(gj), name


@pytest.mark.parametrize("rewrite", [True, False])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name", GRAPHS)
def test_plan_matches_reference(name, engine, rewrite):
    cfg = dict(engine=engine, rewrite=rewrite)
    pj = rc.plan({**rg.BENCHMARK_GRAPHS, **rg.FULL_NETWORKS}[name](),
                 rc.PlanConfig(**cfg), cache=False)
    pt = tc.plan({**tg.BENCHMARK_GRAPHS, **tg.FULL_NETWORKS}[name](),
                 tc.PlanConfig(**cfg), cache=False)
    _assert_same_plan(pj, pt, (name, engine, rewrite))


@pytest.mark.parametrize("seed", range(20))
def test_plan_matches_reference_on_seeded_corpus(seed):
    gj = random_pipeline_graph(seed)
    gt = tc.Graph.build(tc.graph_to_specs(gj), gj.name)
    for engine, rewrite in itertools.product(ENGINES, (True, False)):
        cfg = dict(engine=engine, rewrite=rewrite)
        pj = rc.plan(gj, rc.PlanConfig(**cfg), cache=False)
        pt = tc.plan(gt, tc.PlanConfig(**cfg), cache=False)
        _assert_same_plan(pj, pt, (seed, engine, rewrite))


@pytest.mark.parametrize(
    "n,k,p,seed",
    [(32, 4, 0.75, 10), (32, 4, 0.75, 100)]
    + [(n, k, p, s) for n, k, p, s in itertools.product(
        (5, 12, 33), (2, 3, 4), (0.0, 0.3, 1.0), (0, 7))])
def test_watts_strogatz_matches_networkx(n, k, p, seed):
    want = {tuple(sorted(e)) for e in
            nx.connected_watts_strogatz_graph(n, k, p, seed=seed).edges()}
    assert connected_watts_strogatz_edges(n, k, p, seed) == want


def test_plan_caches_keep_apart_on_disk():
    assert tc_cache._ENV_DIR != rc_cache._ENV_DIR
    blob_t = tc_cache.frame_blob(b"payload")
    blob_j = rc_cache.frame_blob(b"payload")
    assert rc_cache.unframe_blob(blob_t) is None
    assert tc_cache.unframe_blob(blob_j) is None
    assert tc_cache.unframe_blob(blob_t) == b"payload"
    assert tc_cache._options_key(("x",)) != rc_cache._options_key(("x",))


def test_plan_cache_round_trips_through_disk(tmp_path):
    g = tg.swiftnet_cell("A")
    cold = tc.plan(g, tc.PlanConfig(), cache=tc.PlanCache(disk_dir=tmp_path))
    warm = tc.plan(g, tc.PlanConfig(), cache=tc.PlanCache(disk_dir=tmp_path))
    names = [f.name for f in tmp_path.iterdir()]
    assert names and all(n.endswith(".tplan.pkl") for n in names)
    assert list(warm.order) == list(cold.order)
    assert warm.peak_bytes == cold.peak_bytes == 2809856
