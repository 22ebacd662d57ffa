"""The port's graph bridge (``repro_torch.core.fx_bridge``) against the JAX
package's jaxpr bridge (``repro.core.jax_bridge``).

The same numpy inputs, made from a seed, go through each bridge function
of ``repro_torch.graphs.programs`` and its ``jax.numpy`` original (copied
below from ``repro``'s tests and bench): outputs allclose (f32 rtol/atol
1e-5, bf16 to one ulp), the reports' invariants, and the peaks and arena
bytes integer-equal wherever the lifted sizes agree.  The planner itself:
the port's lifted graph, rebuilt as a ``repro`` graph from the same specs,
gets the same order, peak, arena bytes and offsets from both packages.
Also the lifting rules (a tuple-returning op is one node, a constant is no
node, a bool is bypassed), gradients through ``serenity_transform``,
``memory_aware_remat``'s decision, the plan cache, the arena program's
call counts and outputs that alias no arena byte, and a mocked card on
which a failing kernel raises out of ``compile_scheduled``.
"""

import operator

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as rc  # noqa: E402
from repro.core import jax_bridge as jb  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.core import fx_bridge as fb  # noqa: E402
from repro_torch.graphs import programs as P  # noqa: E402
from repro_torch.kernels import _grad  # noqa: E402
from repro_torch.kernels.arena import kernel as arena_kernel  # noqa: E402

SEED = 0
RTOL = ATOL = 1e-5


# -- the jax.numpy originals (tests/test_jax_bridge.py, tests/test_executor.py,
#    benchmarks/bench_jaxpr_sched.py) ----------------------------------------

def j_wide(x):
    hs = [jnp.tanh(x * i) @ jnp.ones((64, 256)) for i in range(1, 5)]
    return sum((h @ jnp.ones((256, 4))).sum() for h in hs)


def j_nas_cell(x):
    branches = []
    for i in range(6):
        h = jnp.tanh(x * (i + 1.0))
        h = h @ jnp.ones((x.shape[-1], 4 * x.shape[-1]), x.dtype)
        h = jax.nn.relu(h)
        h = h @ jnp.ones((4 * x.shape[-1], 16), x.dtype)
        branches.append(h)
    return jnp.sum(jnp.concatenate(branches, -1) ** 2)


def j_nas_like(x):
    branches = []
    for i in range(4):
        h = jnp.tanh(x * (i + 1.0))
        h = h @ jnp.ones((x.shape[-1], 2 * x.shape[-1]), x.dtype)
        h = jax.nn.relu(h) @ jnp.ones((2 * x.shape[-1], 8), x.dtype)
        branches.append(h)
    return jnp.sum(jnp.concatenate(branches, -1) ** 2)


def j_moe_fanout(x):
    outs = []
    for e in range(8):
        h = x @ jnp.ones((x.shape[-1], 256), x.dtype) * (e + 1)
        outs.append(jax.nn.gelu(h) @ jnp.ones((256, 64), x.dtype))
    return sum(o.sum() for o in outs)


def j_branchy_residual(x):
    hs = [jnp.tanh(x * i) @ jnp.ones((x.shape[-1], 512)) for i in
          range(1, 7)]
    return sum((h @ jnp.ones((512, 8))).sum() for h in hs)


def j_mixed(a, b):
    c = (a * 2).astype(jnp.bfloat16)
    d = jnp.sum(c.astype(jnp.float32)) + b
    return {"c": c, "d": d, "count": (a > 0).sum()}


JAX_FNS = {"wide": j_wide, "nas_cell": j_nas_cell, "nas_like": j_nas_like,
           "moe_fanout": j_moe_fanout, "branchy_residual": j_branchy_residual,
           "mixed": j_mixed}
NAMES = list(JAX_FNS)
# lifted sizes agree node for node, so the reports are integer-equal
SAME_SIZES = ("wide", "nas_cell", "nas_like", "moe_fanout",
              "branchy_residual")
# where repro is exact (tests/test_jax_bridge.py:59 gates nas_cell)
EXACT = SAME_SIZES


def x_of(name) -> np.ndarray:
    """The seeded f32 input: (8, 64) for ``wide`` (its weights are 64
    wide), the bench's (64, 128) for the rest."""
    shape = (8, 64) if name == "wide" else (64, 128)
    return np.random.default_rng(SEED).standard_normal(shape) \
        .astype(np.float32)


def args_of(name, x: np.ndarray):
    """(torch args, jax args) of one call on the same numpy input."""
    t = P.PROGRAMS[name][1](torch.from_numpy(x.copy()))
    if name == "mixed":
        return t, (jnp.asarray(x), jnp.float32(3.0))
    return t, (jnp.asarray(x),)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each element's magnitude (8 bits of mantissa)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


@pytest.fixture(scope="module")
def runs():
    """{name: (port wrapped, port outputs, repro wrapped, repro outputs)},
    each bridge compiled once on the seeded input."""
    out = {}
    for name in NAMES:
        t_args, j_args = args_of(name, x_of(name))
        ft = fb.compile_scheduled(P.PROGRAMS[name][0], device="cpu")
        fj = jb.compile_scheduled(JAX_FNS[name])
        out[name] = (ft, ft(*t_args), fj, fj(*j_args))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_outputs_match_repro(runs, name):
    _, yt, _, yj = runs[name]
    if isinstance(yt, dict):
        assert sorted(yt) == sorted(yj)
        pairs = [(yt[k], yj[k]) for k in sorted(yt)]
    else:
        pairs = [(yt, yj)]
    for a, b in pairs:
        bf16 = a.dtype == torch.bfloat16
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        if bf16:
            # the same rounding of the same f32 product, to one ulp
            assert np.all(np.abs(a - b) <= bf16_ulp(b)), name
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_report_invariants(runs, name):
    r = runs[name][0].report
    assert r.optimal_peak <= r.original_peak
    assert r.optimal_peak <= r.kahn_peak
    assert r.realized_matches_plan and r.realized_bytes == r.optimal_peak
    assert r.arena_bytes >= r.optimal_peak
    assert r.exact or name not in EXACT
    assert r.n_arena_writes > 0 and r.n_arena_reads > 0


@pytest.mark.parametrize("name", SAME_SIZES)
def test_reports_integer_equal_to_repro(runs, name):
    rt_, rj = runs[name][0].report, runs[name][2].report
    for k in ("original_peak", "kahn_peak", "optimal_peak", "arena_bytes",
              "exact", "realized_bytes", "n_env_bypassed"):
        assert getattr(rt_, k) == getattr(rj, k), (name, k)
    if name == "moe_fanout":
        # jax.nn.gelu's tanh form is seven jaxpr equations of one size,
        # aten's one op: fewer nodes, the same peaks
        assert (rt_.n_eqns, rj.n_eqns) == (64, 120)
    else:
        assert rt_.n_eqns == rj.n_eqns


def test_mixed_sizes_differ_only_by_the_count(runs):
    """``mixed``'s count is int64 in torch and int32 in JAX without x64,
    and JAX converts the bool to int32 in an equation of its own: the
    reports differ for that, and the values agree."""
    _, yt, _, yj = runs["mixed"]
    assert yt["count"].dtype == torch.int64
    assert yj["count"].dtype == jnp.int32
    assert int(yt["count"]) == int(yj["count"])
    assert yt["c"].dtype == torch.bfloat16
    assert runs["mixed"][0].report.n_eqns + 1 == \
        runs["mixed"][2].report.n_eqns


def test_mixed_bypasses_the_bool(runs):
    r = runs["mixed"][0].report
    assert r.n_env_bypassed >= 1
    assert r.realized_matches_plan


def _lift(name):
    fn, mk = P.PROGRAMS[name]
    return fb.fx_to_graph(fb.trace_fn(fn, *mk(torch.from_numpy(
        x_of(name)))))[0]


@pytest.mark.parametrize("name", ["nas_cell", "moe_fanout",
                                  "branchy_residual"])
def test_planner_identical_on_the_same_specs(name):
    gt = _lift(name)
    gj = rc.Graph.build(tc.graph_to_specs(gt), gt.name)
    pt = tc.plan(gt, fb.fx_config())
    pj = rc.plan(gj, jb.jaxpr_config())
    assert list(pt.order) == list(pj.order)
    assert pt.peak_bytes == pj.peak_bytes
    assert pt.arena_bytes == pj.arena_bytes
    for u in range(len(gt)):
        assert pt.arena.offset_of(u) == pj.arena.offset_of(u), u


def test_transform_grad_matches_plain_and_repro():
    x = x_of("wide")
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    f2 = fb.serenity_transform(P.wide)
    y = f2(xt)
    assert f2.report.optimal_peak <= f2.report.original_peak
    (g2,) = torch.autograd.grad(y, xt)
    xt1 = torch.from_numpy(x.copy()).requires_grad_(True)
    (g1,) = torch.autograd.grad(P.wide(xt1), xt1)
    torch.testing.assert_close(g2, g1, rtol=RTOL, atol=ATOL)
    gj = np.asarray(jax.grad(jb.serenity_transform(j_wide))(jnp.asarray(x)))
    # across libraries tanh differs in the last ulp, which 1 - tanh^2
    # magnifies where tanh saturates: within 1e-5 of the largest gradient
    np.testing.assert_allclose(g2.numpy(), gj, rtol=RTOL,
                               atol=ATOL * np.abs(gj).max())


def test_reordered_module_follows_the_order():
    x = torch.from_numpy(x_of("branchy_residual"))
    gm = fb.trace_fn(P.branchy_residual, x)
    new_gm, report = fb.schedule_fx(gm)
    _, ids = fb.fx_to_graph(gm)
    name_of = {nid: n.name for n, nid in ids.items()}
    ops = [n.name for n in new_gm.graph.nodes if n.op == "call_function"
           and n.target is not operator.getitem]
    assert ops == [name_of[u] for u in report.order
                   if name_of[u] in set(ops)]
    assert report.order != sorted(report.order)
    torch.testing.assert_close(new_gm(x)[0], P.branchy_residual(x),
                               rtol=RTOL, atol=ATOL)


def test_memory_aware_remat_decision():
    x = torch.from_numpy(x_of("wide"))
    fn_lo, dec_lo = fb.memory_aware_remat(P.wide, 10**12, x)
    assert not dec_lo["remat"] and fn_lo is P.wide
    fn_hi, dec_hi = fb.memory_aware_remat(P.wide, 1, x)
    assert dec_hi["remat"]
    _, dec_j = jb.memory_aware_remat(j_wide, 1, jnp.asarray(x_of("wide")))
    assert dec_hi == dec_j
    xg = x.clone().requires_grad_(True)
    y = fn_hi(xg)
    torch.testing.assert_close(y, P.wide(x), rtol=RTOL, atol=ATOL)
    (g,) = torch.autograd.grad(y, xg)
    xg1 = x.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(P.wide(xg1), xg1)
    torch.testing.assert_close(g, g1, rtol=RTOL, atol=ATOL)


def test_plan_cache_hit_on_second_schedule():
    pc = tc.PlanCache()
    gm = fb.trace_fn(P.nas_like, torch.from_numpy(x_of("nas_like")))
    _, r1 = fb.schedule_fx(gm, cache=pc)
    hits = pc.stats.hits
    _, r2 = fb.schedule_fx(fb.trace_fn(
        P.nas_like, torch.from_numpy(x_of("nas_like"))), cache=pc)
    assert pc.stats.hits == hits + 1
    assert (r2.order, r2.optimal_peak, r2.arena_bytes) == \
        (r1.order, r1.optimal_peak, r1.arena_bytes)


W = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 8))
                     .astype(np.float32))


def tuple_ops(x):
    y, idx = torch.max(x @ W, dim=1)
    a, b = torch.split(x, 4, dim=1)
    return y + idx + a.sum() + b.sum(), torch.tanh(b)


def test_tuple_ops_and_a_constant_lift_as_the_rules_say():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((5, 8))
                         .astype(np.float32))
    gm = fb.trace_fn(tuple_ops, x)
    assert sum(n.op == "get_attr" for n in gm.graph.nodes) == 1
    g, ids = fb.fx_to_graph(gm)
    # a constant is no node, a getitem none either
    assert all(n.op in ("placeholder", "call_function") for n in ids)
    assert not any(n.target is operator.getitem for n in ids)
    assert sum(n.op == "call_function" and n.target is operator.getitem
               for n in gm.graph.nodes) == 4
    by_op = {nd.op: nd for nd in g.nodes}
    mx, sp = by_op["aten.max.dim"], by_op["aten.split.Tensor"]
    assert mx.size_bytes == 5 * 4 + 5 * 8          # values f32, indices i64
    assert sp.size_bytes == 5 * 8 * 4               # both halves
    mm = by_op["aten.mm.default"]
    assert mm.preds == (0,)                          # W is not a node
    f = fb.compile_scheduled(tuple_ops, device="cpu")
    got, want = f(x), tuple_ops(x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
    assert f.report.realized_matches_plan


def test_arena_calls_per_run_and_no_aliased_output(monkeypatch):
    """Each threaded tensor is written once and each op reads each
    distinct threaded input once; every output survives the arena being
    overwritten afterwards (none is a view of it)."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((5, 8))
                         .astype(np.float32))
    gm = fb.trace_fn(tuple_ops, x)
    _, report = fb.schedule_fx(gm)
    run, bypassed, n_w, n_r = fb._build_arena_program(
        gm, fb.fx_to_graph(gm)[1], report.order, report.arena_plan)
    calls = {"write": 0, "read": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fb, "arena_write", counting("write", fb.arena_write))
    monkeypatch.setattr(fb, "arena_read", counting("read", fb.arena_read))
    arena = torch.zeros(report.arena_bytes, dtype=torch.uint8)
    outs = run(arena, [x])
    assert (calls["write"], calls["read"]) == (n_w, n_r)
    # the input, mm, max's 2 outputs, split's 2 and 6 ops after
    assert bypassed == 0 and n_w == 12
    want = [o.clone() for o in outs]
    arena.fill_(0xAB)
    for o, w in zip(outs, want):
        assert torch.equal(o, w)
        assert o.untyped_storage().data_ptr() != \
            arena.untyped_storage().data_ptr()


def test_entry_points_default_to_the_card_and_refuse_jit_on_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tc.ExecutorError, match="CUDA is not available"):
        fb.compile_scheduled(P.nas_like)
    with pytest.raises(tc.ExecutorError, match="CUDA graph"):
        fb.compile_scheduled(P.nas_like, device="cpu", jit=True)
    f = fb.compile_scheduled(P.nas_like, device="cpu")
    with pytest.raises(tc.ExecutorError, match="lies on"):
        f(torch.ones(4, 8, device="meta"))


@pytest.mark.parametrize("op", ["write", "read"])
def test_mock_card_kernel_error_propagates(monkeypatch, op):
    """On a mocked card (CPU tensors taken for the card's, as
    ``tests/test_torch_train.py`` mocks it) the arena ops launch the kernel
    entries, once per threaded write and read; a kernel that fails raises
    out of compile_scheduled, with no plain-version retry."""
    from repro_torch.kernels.arena import ref

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(_grad, "on_card", lambda t: True)
    plain = {"write": ref.arena_write_torch, "read": ref.arena_read_torch}
    calls = []

    def mocked(name):
        def run(*a, **kw):
            calls.append(name)
            return plain[name](*a, **kw)
        return run

    for name in plain:
        monkeypatch.setattr(arena_kernel, f"arena_{name}_cuda", mocked(name))
    f = fb.compile_scheduled(P.nas_like, device="cpu", assert_equiv=False)
    x = torch.from_numpy(x_of("nas_like"))
    y = f(x)
    r = f.report
    assert calls.count("write") == r.n_arena_writes
    assert calls.count("read") == r.n_arena_reads
    torch.testing.assert_close(y, P.nas_like(x), rtol=RTOL, atol=ATOL)

    def broken(*a, **kw):
        raise arena_kernel.KernelLaunchError(f"arena_{op}: launch refused")

    monkeypatch.setattr(arena_kernel, f"arena_{op}_cuda", broken)
    with pytest.raises(arena_kernel.KernelLaunchError, match="refused"):
        f(x)


@pytest.mark.parametrize("card", [False, True], ids=["cpu", "mock_card"])
def test_input_that_requires_grad_raises(monkeypatch, card):
    """The arena program has no backward: an input that requires a
    gradient raises before any arena op runs, on the CPU and on a mocked
    card, instead of returning outputs detached from autograd; under
    ``torch.no_grad()`` the same call runs."""
    calls = []
    if card:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(_grad, "on_card", lambda t: True)
        for name in ("write", "read"):
            monkeypatch.setattr(arena_kernel, f"arena_{name}_cuda",
                                lambda *a, _n=name, **kw: calls.append(_n))
    f = fb.compile_scheduled(P.nas_like, device="cpu", assert_equiv=False)
    x = torch.from_numpy(x_of("nas_like")).requires_grad_()
    with pytest.raises(NotImplementedError, match="requires a gradient"):
        f(x)
    assert calls == [] and f.report is None
    if not card:
        with torch.no_grad():
            y = f(x)
        torch.testing.assert_close(y, P.nas_like(x.detach()), rtol=RTOL,
                                   atol=ATOL)


def test_quickstart_torch_runs_on_the_cpu(capsys):
    import runpy
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / \
        "quickstart_torch.py"
    runpy.run_path(str(path))["main"](["--device", "cpu"])
    out = capsys.readouterr().out
    assert "(== planned: True)" in out
    assert "realized == planned: True" in out
    assert "output preserved: True" in out
