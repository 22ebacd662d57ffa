"""The WKV-6 gradient in the port (``kernels/rwkv6``), on the CPU.

The backward kernel (``csrc/wkv6_backward.cu``) runs on the card only; what
it is held against and what surrounds it run here:

  * ``wkv6_backward_torch`` (the reverse scan in plain torch, the f32
    states recomputed forward) against ``jax.vjp`` of ``repro``'s
    ``wkv6_ref`` and against torch's autograd of the port's ``wkv6_ref``:
    f32, B 2, T 1, 7, 64 and 300, H 2, N 16 and 64, with and without s0 and
    dsT, numpy inputs from a seed with w drawn across (0, 1), values that
    round to 0 and to 1 in bf16 among them; each gradient within 1e-5 of
    its largest magnitude (sums in another order);
  * with bf16 inputs the plain backward is its f32 gradient of the same
    values rounded once (what the card's one-ulp limit rests on);
  * the cost the dry-run and the bound count: the work the gradient
    needs, the state walked forward once;
  * the kernel's constants, grid, thread layout and shared memory against
    the source: a cluster of BACKWARD_CLUSTER blocks a (batch row, head),
    every state element owned by one thread of one block of the cluster, a
    row's threads on one warp's neighbouring lanes, each dv column written
    by one block after the ranks' partials are added in rank order, every
    staged element copied once, shared memory at most 227 KB (two blocks
    an SM at bf16, N 64);
  * ``wkv6_backward_cuda`` raises on CPU tensors and launches nothing;
  * ``WKV6Fn`` on a mocked card (the device test answering "on the card",
    the kernel entries the plain versions run without autograd, as a
    ctypes launch is): ``wkv6(impl="cuda")`` under autograd returns
    outputs with a ``grad_fn`` whose gradients equal autograd's of the
    plain recurrence, an in-place ``state_out`` under autograd is refused,
    and under ``torch.no_grad()`` the in-place threading serving uses still
    runs;
  * the smoke ``rwkv6-7b`` on that mocked card (recurrent mixing leaves
    filled): its loss and every gradient leaf through ``WKV6Fn`` (the
    backward entry counted, one a layer) against ``jax.value_and_grad`` of
    ``repro``'s ``loss_fn(impl="xla")``, the loss within 1e-5, each leaf
    within 1e-4 of its largest.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.models.zoo import build_model as jax_build  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import _grad  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wk  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import (  # noqa: E402
    wkv6_backward_torch,
    wkv6_ref,
)
from repro_torch.models.params import (  # noqa: E402
    params_from_numpy,
    tree_leaves,
    tree_map,
)
from repro_torch.models.zoo import build_model  # noqa: E402

from test_torch_recurrent_models import live_leaves  # noqa: E402

NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def _w(rng, shape):
    """Decays across (0, 1): exp(-exp(omega)) with omega over [-12, 6], so
    that some round to 1 in bf16 (exp(omega) under 2^-9) and some to 0
    (exp(omega) past ~90)."""
    om = rng.uniform(-12.0, 6.0, shape)
    return np.exp(-np.exp(om)).astype(np.float32)


def _inputs(seed, B, T, H, N, with_s0):
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.standard_normal((B, T, H, N)).astype(np.float32)
                   for _ in range(4))
    w = _w(rng, (B, T, H, N))
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = dsT = None
    if with_s0:
        s0, dsT = (rng.standard_normal((B, H, N, N)).astype(np.float32)
                   for _ in range(2))
    return r, k, v, w, u, s0, do, dsT


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what, rtol=1e-5):
    w = np.asarray(want, np.float32)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - w).max())
    assert err <= rtol * scale, (what, err, scale)


def _hold(g, w_, what):
    """f32: within 1e-5 of the largest magnitude; bf16 (both sides round one
    f32 sum, taken in another order): within one bf16 ulp of each element
    plus 1e-5 of the largest."""
    assert g.dtype == w_.dtype and g.shape == w_.shape, what
    if g.dtype == torch.float32:
        _close(g.detach().numpy(), w_.detach().numpy(), what)
        return
    gf, wf = g.detach().float(), w_.detach().float()
    ulp = torch.where(wf == 0, torch.zeros_like(wf), 2.0 ** (
        torch.floor(torch.log2(wf.abs())) - 7))
    tol = ulp + 1e-5 * float(wf.abs().max())
    assert bool(((gf - wf).abs() <= tol).all()), what


def test_decays_reach_bf16s_ends():
    w = torch.from_numpy(_w(np.random.default_rng(0), (4096,)))
    wb = w.to(torch.bfloat16)
    assert (wb == 0).any() and (wb == 1).any()
    assert ((w > 0) & (w < 1)).float().mean() > 0.5


@pytest.mark.parametrize("T", [1, 7, 64, 300])
@pytest.mark.parametrize("N", [16, 64])
@pytest.mark.parametrize("with_s0", [False, True])
def test_plain_backward_matches_jax_vjp_and_autograd(T, N, with_s0):
    B, H = 2, 2
    r, k, v, w, u, s0, do, dsT = _inputs(10 * T + N + with_s0, B, T, H, N,
                                         with_s0)
    got = wkv6_backward_torch(*(_t(a) for a in (r, k, v, w, u, s0, do, dsT)))
    assert all(g.dtype == torch.float32 for g in got if g is not None)
    assert (got[5] is None) == (s0 is None)
    cot = (jnp.asarray(do), jnp.zeros((B, H, N, N), jnp.float32)
           if dsT is None else jnp.asarray(dsT))
    prim = tuple(jnp.asarray(a) for a in (r, k, v, w, u)) + (
        () if s0 is None else (jnp.asarray(s0),))
    _, vjp = jax.vjp(jax_wkv6_ref, *prim)
    wants = {"jax.vjp of wkv6_ref": [np.asarray(g) for g in vjp(cot)]}
    leaves = [_t(a).requires_grad_(True) for a in (r, k, v, w, u, s0)
              if a is not None]
    o, sT = wkv6_ref(*leaves)
    loss = (o * _t(do)).sum() + (0 if dsT is None else (sT * _t(dsT)).sum())
    # w of the last step reaches only the final state: without dsT it is
    # unused (a zero gradient)
    wants["torch autograd"] = [g.numpy() for g in torch.autograd.grad(
        loss, leaves, allow_unused=True, materialize_grads=True)]
    for name, want in wants.items():
        assert len(want) == len([g for g in got if g is not None])
        for g, w_, what in zip(got, want, NAMES):
            _close(g.numpy(), w_, f"{what} vs {name}")


@pytest.mark.parametrize("T", [1, 9, 64])
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("with_s0", [False, True])
def test_plain_backward_in_bf16_rounds_the_f32_gradient_once(T, N, with_s0):
    # the card's bf16 limit (one ulp) rests on this: with bf16 inputs the
    # plain version is its f32 gradient of the same values, rounded once
    args = [_t(a) for a in _inputs(T + N, 2, T, 2, N, with_s0)]
    for i in (0, 1, 2, 3, 4, 6):
        args[i] = args[i].to(torch.bfloat16)
    got = wkv6_backward_torch(*args)
    want = wkv6_backward_torch(*(None if a is None else a.float()
                                 for a in args))
    for g, w_, what in zip(got, want, NAMES):
        if w_ is None:
            assert g is None
            continue
        dtype = torch.float32 if what == "ds0" else torch.bfloat16
        assert g.dtype == dtype and torch.equal(g, w_.to(dtype)), what


def _shape_constants():
    """``struct Shape``'s constants of the source, and the namespace's."""
    text = wk.BACKWARD_SOURCE.read_text()
    body = text[text.index("struct Shape {"):]
    body = body[:body.index("};")]
    return text, re.findall(r"static constexpr int (\w+) = ([^;]+);", body)


def _eval_shape(N, esz=2):
    """Shape<T, N>'s constants evaluated at N, with sizeof(T) = esz."""
    text, lines = _shape_constants()
    env = {"N": N}
    for name in ("kRowLanes", "kChunk", "kInterval", "kCluster", "kRing",
                 "kBlocksSM"):
        env[name] = int(re.search(rf"constexpr int {name} = (\d+);",
                                  text).group(1))
    for name, expr in lines:
        expr = expr.replace("(int)sizeof(T)", str(esz)).replace("/", "//")
        env[name] = eval(expr, {}, dict(env))
    return env


def test_backward_constants_and_grid_are_the_sources():
    text = wk.BACKWARD_SOURCE.read_text()
    for N in wk.HEAD_SIZES:
        env = _eval_shape(N)
        assert (env["kRowLanes"], env["kChunk"], env["kInterval"],
                env["kCluster"]) == wk.BACKWARD_CONSTANTS
        NR, KC, RW, W = wk.backward_shape(N)
        assert (env["NR"], env["kCols"], env["RW"], env["W"]) == (NR, KC,
                                                                  RW, W)
        for esz in (2, 4):
            e = _eval_shape(N, esz)
            assert e["kBytes"] == wk.backward_smem_bytes(N, esz)
            assert e["kBytes"] <= 227 * 1024
        # thread tid of the block of rank q: row q NR + tid / row lanes,
        # columns [KC cg, KC cg + KC); every element of the state once
        # across the cluster, a row's lanes neighbouring lanes of one warp
        L = wk.BACKWARD_ROW_LANES
        seen = np.zeros((N, N), np.int64)
        tid = np.arange(env["kThreads"])
        i, cg = tid // L, tid % L
        for blk in range(wk.BACKWARD_CLUSTER):
            b, h, i0, i1 = wk.backward_block(blk, 3, N)
            assert (b, h) == (0, 0) and i1 - i0 == NR
            for q in range(KC):
                np.add.at(seen, (i0 + i, cg * KC + q), 1)
        assert (seen == 1).all()
        assert ((tid // 32) == (i // RW)).all() and W * 32 == env["kThreads"]
        # dv: block rank q writes the columns [q N / CL, (q + 1) N / CL) of
        # each of a chunk's steps, a thread one (step, column)
        cols = np.zeros((wk.BACKWARD_CHUNK, N), np.int64)
        for rank in range(wk.BACKWARD_CLUSTER):
            sv = tid // (N // wk.BACKWARD_CLUSTER)
            jv = rank * (N // wk.BACKWARD_CLUSTER) + tid % (
                N // wk.BACKWARD_CLUSTER)
            live = sv < wk.BACKWARD_CHUNK
            np.add.at(cols, (sv[live], jv[live]), 1)
        assert (cols == 1).all()
        # the staged chunk: copy c of (step, array, kVec elements), every
        # element of the five arrays' chunk once
        vec = 16 // 2
        per_row = N // vec
        staged = np.zeros((wk.BACKWARD_CHUNK, 5, N), np.int64)
        for c in range(wk.BACKWARD_CHUNK * 5 * per_row):
            s, a = c // (5 * per_row), (c // per_row) % 5
            n = (c % per_row) * vec
            staged[s, a, n:n + vec] += 1
        assert (staged == 1).all()
    # two blocks an SM at rwkv6-7b's bf16 training shape
    assert 2 * (wk.backward_smem_bytes(64, 2) + 1024) <= 228 * 1024
    assert "const int i = tid / kRowLanes, cg = tid % kRowLanes, j0 = cg * KC;" \
        in text
    assert "const int gi = rank * NR + i;" in text
    # a cluster of kCluster blocks a (batch row, head), launched B H kCluster
    assert "__global__ void __cluster_dims__(kCluster, 1, 1)" in text
    assert "<<<static_cast<unsigned>(B * H * L::CL), L::kThreads, L::kBytes," \
        in text
    assert "const long long bh = blockIdx.x / CL, b = bh / H, h = bh % H;" \
        in text
    assert "const int rank = static_cast<int>(cluster.block_rank());" in text
    assert wk.backward_grid(8, 64) == 8 * 64 * wk.BACKWARD_CLUSTER
    # the merge order: ranks 0 .. CL - 1, each rank's warps 0 .. W - 1,
    # after a cluster barrier
    body = text[text.index("    for (int s = C - 1; s >= 0; --s) back(s);"):]
    assert body.index("cluster.sync();") < body.index("// dv: (step sv")
    merge = body[body.index("// dv: (step sv"):]
    merge = merge[:merge.index("store(dv")]
    assert "for (int q = 0; q < CL; ++q) {" in merge
    assert "cluster.map_shared_rank(pt, q) + sv * W * N + jv;" in merge
    assert "for (int x = 0; x < W; ++x) {" in merge
    assert "acc = q == 0 && x == 0 ? pr[0] : __fadd_rn(acc, pr[x * N]);" \
        in merge
    for sfx in ("bf16", "f32"):
        assert f"int repro_wkv6_backward_{sfx}(" in text


@pytest.mark.parametrize("s0", [False, True])
@pytest.mark.parametrize("dsT", [False, True])
def test_backward_cost_counts_the_functions_work(s0, dsT):
    from repro_torch.kernels import costs
    flops, nbytes = costs.wkv6_backward_cost(8, 256, 64, 64, 2, s0=s0,
                                             dsT=dsT)
    # the state walked forward once (3 N^2 a step), the reverse's 11 N^2 +
    # 16 N a step: 7.65 GFLOP, the kernel's second walk not counted
    assert flops == 512 * 256 * (14 * 4096 + 16 * 64) == 7_650_410_496
    # nine (B, T, H, N) bf16 tensors and u, du; s0 read and ds0 written
    # only with s0, dsT read where given
    assert nbytes == 9 * 2 * 8 * 256 * 64 * 64 + 2 * 2 * 64 * 64 \
        + (2 * s0 + dsT) * 4 * 8 * 64 * 64 * 64


def test_backward_wrapper_raises_on_cpu_tensors():
    args = [_t(a) for a in _inputs(1, 1, 9, 2, 16, True)]
    wk.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wk.wkv6_backward_cuda(*args)
    assert wk.LAUNCHES == {"wkv6": 0, "wkv6_backward": 0}


def _detached(fn):
    def run(*a, **kw):
        with torch.no_grad():
            return fn(*a, **kw)
    return run


@pytest.fixture
def on_card(monkeypatch):
    monkeypatch.setattr(_grad, "on_card", lambda t: True)
    monkeypatch.setattr(wk, "wkv6_cuda", _detached(
        lambda r, k, v, w, u, *, initial_state=None, state_out=None:
        wkv6_ref(r, k, v, w, u, initial_state, state_out)))
    monkeypatch.setattr(wk, "wkv6_backward_cuda",
                        _detached(wkv6_backward_torch))


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_on_mocked_card_matches_autograd(on_card, with_s0, dtype):
    r, k, v, w, u, s0, do, dsT = (_t(a) for a in _inputs(
        5, 2, 19, 2, 16, with_s0))
    leaves = [x.to(dtype).requires_grad_(True) for x in (r, k, v, w, u)]
    if s0 is not None:
        leaves.append(s0.clone().requires_grad_(True))
    out, sT = wops.wkv6(*leaves[:5], initial_state=(
        leaves[5] if s0 is not None else None), impl="cuda")
    assert out.grad_fn is not None and "WKV6Fn" in type(out.grad_fn).__name__
    loss = (out.float() * do).sum() + (0 if dsT is None else (sT * dsT).sum())
    got = torch.autograd.grad(loss, leaves)
    ref = [x.detach().clone().requires_grad_(True) for x in leaves]
    o_r, sT_r = wkv6_ref(*ref)
    loss_r = (o_r.float() * do).sum() + (
        0 if dsT is None else (sT_r * dsT).sum())
    want = torch.autograd.grad(loss_r, ref)
    for g, w_, what in zip(got, want, NAMES):
        _hold(g, w_, what)


def test_state_out_under_autograd_refused_and_served_in_place(on_card):
    r, k, v, w, u, s0, _, _ = (_t(a) for a in _inputs(6, 1, 5, 2, 16, True))
    rg = r.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="state_out"):
        wops.wkv6(rg, k, v, w, u, initial_state=s0, impl="cuda",
                  state_out=s0)
    # serving: no autograd, the cache's state threaded in place
    state = s0.clone()
    with torch.no_grad():
        out, sT = wops.wkv6(rg, k, v, w, u, initial_state=state,
                            impl="cuda", state_out=state)
    want_o, want_s = wkv6_ref(r, k, v, w, u, s0)
    assert sT is state and torch.equal(state, want_s)
    assert out.grad_fn is None and torch.equal(out, want_o)


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_mock_rwkv6_loss_grads_match_repro(on_card, monkeypatch):
    # the smoke rwkv6-7b on the mocked card: every WKV-6 gradient through
    # WKV6Fn, whose backward entry is counted, one a layer
    arch = "rwkv6-7b"
    calls = []
    backward = wk.wkv6_backward_cuda
    monkeypatch.setattr(wk, "wkv6_backward_cuda",
                        lambda *a: calls.append(1) or backward(*a))
    jm = jax_build(jconfigs.smoke(arch))
    tm = build_model(tconfigs.smoke(arch))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      live_leaves(arch, jm.init(jax.random.PRNGKey(2))))
    tp = tree_map(lambda t: t.float(),
                  params_from_numpy(tm.defs, _np32(jp), "cpu"))
    tokens = np.random.default_rng(8).integers(
        0, tm.cfg.vocab_size, (2, 12)).astype(np.int32)
    (jl, _), jg = jax.value_and_grad(lambda p: jm.loss_fn(
        p, {"tokens": jnp.asarray(tokens)}, impl="xla"), has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = tm.loss_fn(tp, {"tokens": torch.from_numpy(tokens)})
    tg = torch.autograd.grad(tl, leaves)
    assert len(calls) == tm.cfg.n_layers
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    ja = jax.tree.leaves(jg)
    assert len(ja) == len(tg)
    for a, b in zip(ja, tg):
        a = np.asarray(a)
        assert b.shape == a.shape
        scale = max(float(np.abs(a).max()), 1e-12)
        assert float(np.abs(b.numpy() - a).max()) <= 1e-4 * scale, a.shape
    assert max(float(np.abs(np.asarray(a)).max()) for a in ja) > 1e-3
