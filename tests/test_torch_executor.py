"""The port's arena executor on the CPU against the JAX package's.

Both packages plan the same graph and run it on the same numpy inputs.  The
port's values are allclose to ``repro``'s ``run_reference`` and to its
``execute_plan(impl='xla')`` at rtol 1e-5, atol 1e-5: XLA's and torch's
``tanh``/``cos`` differ in the last ulp, and the surrogate numerics carry
that through up to a few hundred nodes.  Inside the port the contract is
exact: fused == slice == ``run_reference``, bit for bit, and realized ==
planned bytes.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP pool on 150k-element ops would take the cores from the others
torch.set_num_threads(1)

import repro.core as rc  # noqa: E402
import repro.core.executor as rx  # noqa: E402
import repro.graphs as rg  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.graphs as tg  # noqa: E402
from repro_torch.core import executor as tx  # noqa: E402

RTOL = ATOL = 1e-5

CELLS = {
    "darts_cell": (rg.darts_normal_cell, tg.darts_normal_cell),
    "swiftnet_c": (lambda: rg.swiftnet_cell("C"),
                   lambda: tg.swiftnet_cell("C")),
    "randwire_10": (lambda: rg.randwire_graph(seed=10),
                    lambda: tg.randwire_graph(seed=10)),
    "darts_net_x6": (rg.FULL_NETWORKS["darts_net_x6"],
                     tg.FULL_NETWORKS["darts_net_x6"]),
}
ALL_GRAPHS = sorted({**tg.BENCHMARK_GRAPHS, **tg.FULL_NETWORKS})


def _inputs(g, seed=0):
    rng = np.random.default_rng(seed)
    return {g.nodes[u].name: rng.standard_normal(g.sizes[u] // 4)
            .astype(np.float32) for u in tx.input_nodes(g)}


def _port_plan(name, **cfg):
    mk = {**tg.BENCHMARK_GRAPHS, **tg.FULL_NETWORKS}[name]
    return tc.plan(mk(), tc.PlanConfig(**cfg))


# the full network runs rewritten only, to keep tier-1 short; the cells
# cover the plain graphs
CASES = [(cell, rewrite, fuse) for cell in sorted(CELLS)
         for rewrite in (False, True) for fuse in (False, True)
         if rewrite or cell != "darts_net_x6"]


@functools.lru_cache(maxsize=None)
def _jax_reference(cell, rewrite):
    """``repro``'s plan and ``run_reference`` outputs, shared by the slice
    and fused cases of one cell."""
    pj = rc.plan(CELLS[cell][0](), rc.PlanConfig(rewrite=rewrite))
    inputs = _inputs(pj.graph)
    return pj, inputs, rc.run_reference(pj.graph, inputs)


@pytest.mark.parametrize("cell,rewrite,fuse", CASES)
def test_execute_matches_reference_package(cell, rewrite, fuse):
    pj, inputs, want_ref = _jax_reference(cell, rewrite)
    pt = tc.plan(CELLS[cell][1](), tc.PlanConfig(rewrite=rewrite))
    res = tc.execute_plan(pt.graph, pt.order, pt.arena, inputs, fuse=fuse,
                          device="cpu")
    assert res.realized_matches_plan
    assert (res.realized_peak_bytes, res.realized_arena_bytes) == \
        (pj.peak_bytes, pj.arena_bytes)
    want_xla = rc.execute_plan(pj.graph, pj.order, pj.arena, inputs,
                               impl="xla", fuse=fuse).outputs
    assert set(res.outputs) == set(want_ref) == set(want_xla)
    for k, v in res.outputs.items():
        assert v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_allclose(v.numpy(), np.asarray(want_ref[k]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(want_xla[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ALL_GRAPHS)
def test_fused_equals_slice_equals_reference_bitwise(name):
    p = _port_plan(name)
    inputs = _inputs(p.graph, seed=1)
    ref = tc.run_reference(p.graph, inputs, device="cpu")
    for fuse in (False, True):
        res = tc.execute(p.graph, inputs, p.arena, order=p.order, fuse=fuse,
                         device="cpu")
        assert res.realized_matches_plan
        for k, v in ref.items():
            assert torch.equal(res.outputs[k], v), (name, fuse, k)


def test_fusion_counts_match_reference():
    p = _port_plan("darts_imagenet_cell")
    prog = tc.compile_plan(p.graph, p.order, p.arena, fuse=True,
                           device="cpu")
    assert (prog.n_regions, prog.n_fused_nodes,
            max(len(r) for r in prog.regions)) == (31, 23, 4)
    assert len(prog._groups) == 7      # chain-kernel launches
    assert tc.compile_plan(p.graph, p.order, p.arena, fuse=True,
                           device="cpu") is prog
    assert prog.device == torch.device("cpu")
    assert all("cpu" in k for k in p.arena._programs)


def test_pareto_steps_execute_realized_equals_planned():
    p = _port_plan("swiftnet_cell_c", objective="pareto", max_width=2)
    assert max(len(s) for s in p.steps) == 2
    res = tc.execute(p.graph, None, p.arena, order=p.order, steps=p.steps,
                     device="cpu")
    assert res.realized_matches_plan
    ref = tc.run_reference(p.graph, device="cpu")
    assert all(torch.equal(res.outputs[k], v) for k, v in ref.items())


def test_strict_raises_on_plan_schedule_mismatch():
    p = _port_plan("swiftnet_cell_a")
    kahn = tc.kahn_schedule(p.graph).order
    assert list(kahn) != list(p.order)
    with pytest.raises(tc.ExecutorError, match="realized arena diverges"):
        tc.execute_plan(p.graph, kahn, p.arena, device="cpu")
    res = tc.execute_plan(p.graph, kahn, p.arena, device="cpu", strict=False)
    assert not res.realized_matches_plan
    small = torch.zeros(p.arena_bytes // 4 - 1)
    with pytest.raises(tc.ExecutorError, match="supplied arena"):
        tc.execute_plan(p.graph, p.order, p.arena, device="cpu", arena=small)
    with pytest.raises(tc.ExecutorError, match="float32"):
        tc.execute_plan(p.graph, p.order, p.arena, device="cpu",
                        arena=torch.zeros(p.arena_bytes // 4,
                                          dtype=torch.float64))


def test_supplied_arena_is_written_in_place():
    p = _port_plan("swiftnet_cell_c")
    buf = torch.zeros(p.arena_bytes // 4)
    res = tc.execute_plan(p.graph, p.order, p.arena, device="cpu", arena=buf)
    for u in p.graph.exits():
        off, n = p.arena.offset_of(u) // 4, p.graph.sizes[u] // 4
        assert torch.equal(buf[off:off + n],
                           res.outputs[p.graph.nodes[u].name])


def test_pack_buffers_matches_reference_bytes():
    pj = rc.plan(rg.darts_normal_cell(), rc.PlanConfig())
    pt = tc.plan(tg.darts_normal_cell(), tc.PlanConfig())
    rng = np.random.default_rng(5)
    # int64 is left out: JAX without x64 stores it as int32
    dtypes = (np.float32, np.int32, np.float16, np.uint8, np.int8)
    ids, taken = [], []     # nodes whose first 80 bytes overlap no other's
    for u in pt.order:
        o = pt.arena.offset_of(u)
        if len(ids) < len(dtypes) and \
                all(o + 80 <= t or t + 80 <= o for t in taken):
            ids.append(u)
            taken.append(o)
    arrays = {u: (100 * rng.standard_normal((2, 5))).astype(dt)
              for u, dt in zip(ids, dtypes)}
    got = tc.pack_buffers(pt.arena, arrays, device="cpu")
    want = rx.pack_buffers(pj.arena, arrays, jit=False)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for u, x in arrays.items():
        back = tc.unpack_buffer(got, pt.arena, u, x.shape, x.dtype)
        np.testing.assert_array_equal(back.numpy(), x)
        np.testing.assert_array_equal(
            back.numpy(),
            np.asarray(rx.unpack_buffer(want, pj.arena, u, x.shape, x.dtype)))
    with pytest.raises(tc.ExecutorError, match="bool"):
        tc.pack_buffers(pt.arena, {ids[0]: np.zeros(3, bool)}, device="cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = _port_plan("swiftnet_cell_c")
    calls = [
        lambda: tc.execute_plan(p.graph, p.order, p.arena),
        lambda: tc.execute(p.graph, None, p.arena, order=p.order),
        lambda: tc.run_reference(p.graph),
        lambda: tc.compile_plan(p.graph, p.order, p.arena),
        lambda: tc.pack_buffers(p.arena, {}),
    ]
    for call in calls:
        with pytest.raises(tc.ExecutorError, match="CUDA is not available"):
            call()
