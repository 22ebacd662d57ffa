"""The train step's clip and AdamW update (``repro_torch/kernels/optim``,
``csrc/adamw.cu``) against ``repro``, on the CPU.

* the plain per-leaf squared sums and the global norm against ``repro``'s
  clip norm (``src/repro/launch/steps.py:43-47``) at the smoke
  ``llama3.2-1b``'s gradients, f32, rtol 1e-6;
* the plain clip and ``adamw.update`` against ``repro``'s clip and
  ``repro.optim.adamw.update`` over 3 steps at 1e-6;
* the kernels' decomposition emulated in torch (``ref.sumsq_chunked_torch``,
  ``ref.adamw_update_chunked_torch``: the leaf table, a block a chunk,
  16-byte groups where the addresses allow): the update bit-equal to the
  plain one for f32 and bf16 leaves, the squared sums within f32 rounding,
  and the table covering every element exactly once, at ragged sizes and
  misaligned addresses;
* ``state["step"]`` advanced in place by both optimizers, with the
  checkpoints still round-tripping with ``repro``'s;
* ``CapturedTrainStep`` raising on the CPU and under rules, and the CLI on
  ``--device cpu`` (eager) giving the eager step's losses;
* a CUDA-tensor call whose library cannot be built raising, with no plain
  fallback (the card mocked, as ``tests/test_torch_train.py`` mocks it);
* the ops' costs against hand counts, and the dry-run's counting mode on
  fake tensors counting one launch of each op.
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
from repro.models.zoo import build_model as jax_build  # noqa: E402
from repro.optim.adamw import adamw as jadamw  # noqa: E402
import repro_torch.checkpoint as tckpt  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import _build, _grad, costs  # noqa: E402
from repro_torch.kernels.optim import kernel as OK  # noqa: E402
from repro_torch.kernels.optim import ops as OO  # noqa: E402
from repro_torch.kernels.optim import ref as OR  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    CapturedTrainStep,
    make_optimizer,
    make_train_step,
)
from repro_torch.models.params import is_def, tree_leaves  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.optim import adafactor, adamw  # noqa: E402

f32 = torch.float32
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _np_tree(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# ------------------------------------------------------ parity with repro

def test_norm_equals_repro_at_smoke_llama_gradients():
    jm = jax_build(jconfigs.smoke("llama3.2-1b"))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, jm.cfg.vocab_size, (2, 16)),
                         dtype=jnp.int32)
    grads = jax.grad(lambda p: jm.loss_fn(p, {"tokens": tokens},
                                          impl="xla")[0])(jp)
    leaves = jax.tree.leaves(grads)
    # repro's clip norm (src/repro/launch/steps.py:43-47)
    jnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                         for g in leaves))
    tg = [torch.from_numpy(np.array(g)) for g in leaves]
    # each leaf's sum against the f64 sum of the same f32 squares (XLA's
    # f32 sum, in another order, reads up to ~1.5e-6 from it here); the
    # norm against repro's
    for got, g in zip(OO.sumsq(tg, impl="torch"), tg):
        exact = float(np.sum(np.square(g.numpy()).astype(np.float64)))
        np.testing.assert_allclose(float(got), exact, rtol=1e-6)
    np.testing.assert_allclose(float(OO.global_norm(tg, impl="torch")),
                               float(jnorm), rtol=1e-6)
    assert float(jnorm) > 0


SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4, 6)}


def test_clip_and_adamw_update_match_repro_over_three_steps():
    jopt, topt = jadamw(lr=1e-2, **HYPER), adamw(lr=1e-2, **HYPER)
    p0 = _np_tree(0, SHAPES)
    jp, tp = {k: jnp.asarray(v) for k, v in p0.items()}, _torch_tree(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for s in range(3):
        # the clip bites at the first two steps (norms ~20 and ~2), not
        # at the third (~0.2)
        g = _np_tree(10 + s, SHAPES, scale=10.0 ** (1 - s) * 3)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                             for x in jax.tree.leaves(jg)))
        scale = jnp.minimum(1.0, 1.0 / jnp.maximum(gnorm, 1e-9))
        jg = jax.tree.map(lambda x: x * scale.astype(x.dtype), jg)
        jp, js = jopt.update(jg, js, jp, lr_scale=0.7)
        tg = _torch_tree(g)
        tnorm = OO.global_norm(list(tg.values()), impl="torch")
        tscale = torch.clamp(1.0 / torch.clamp(tnorm, min=1e-9), max=1.0)
        np.testing.assert_allclose(float(tnorm), float(gnorm), rtol=1e-6)
        tp, ts = topt.update(tg, ts, tp, lr_scale=0.7, clip_scale=tscale,
                             impl="torch")
    assert int(ts["step"]) == int(js["step"]) == 3
    for part in ("m", "v"):
        for k in SHAPES:
            np.testing.assert_allclose(ts[part][k].numpy(),
                                       np.asarray(js[part][k]), rtol=1e-6,
                                       atol=1e-12)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


# ----------------------------------------------- the kernels' decomposition

# ragged element counts across chunk boundaries, an empty leaf among them
SIZES = (1, 3, 0, 4097, OK.CHUNK, OK.CHUNK + 1, 2 * OK.CHUNK + 5)


def _leaves(dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    r = lambda n, s: (torch.randn(n, generator=gen) * s)  # noqa: E731
    g = [r(n, 1e-2).to(dtype) for n in SIZES]
    p = [r(n, 2e-2).to(dtype) for n in SIZES]
    m = [r(n, 1e-3) for n in SIZES]
    v = [r(n, 3e-3) ** 2 for n in SIZES]
    return g, p, m, v


def _addrs(dtype, misaligned):
    """Fake (g, p, m, v) addresses a leaf: 16-byte aligned, or 1, 2, 3
    elements past it by leaf."""
    esz = torch.tensor([], dtype=dtype).element_size()
    out = []
    for i in range(len(SIZES)):
        off = (i % 4) if misaligned else 0
        base = (i + 1) << 20
        out.append((base + off * esz, base + off * esz + (1 << 18),
                    base + off * 4 + (2 << 18), base + off * 4 + (3 << 18)))
    return out


@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_update_emulation_bit_equal_to_plain(dtype, misaligned):
    g, p, m, v = _leaves(dtype, 0)
    plain = [[t.clone() for t in ts] for ts in (g, p, m, v)]
    scale, lr = torch.tensor(0.37), torch.tensor(3e-4)
    bc1, bc2 = 1.0 - torch.pow(0.9, torch.tensor(3.0)), \
        1.0 - torch.pow(0.95, torch.tensor(3.0))
    kw = dict(scale=scale, lr=lr, bc1=bc1, bc2=bc2, **HYPER)
    visits = [torch.zeros(n, dtype=torch.int32) for n in SIZES]
    OR.adamw_update_chunked_torch(g, p, m, v, addrs=_addrs(dtype, misaligned),
                                  visits=visits, **kw)
    OR.adamw_update_torch(*plain, **kw)
    for got, want in zip(p + m + v, plain[1] + plain[2] + plain[3]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert all(bool((x == 1).all()) for x in visits)
    # the parameters moved
    assert not all(torch.equal(a, b) for a, b in zip(p, _leaves(dtype, 0)[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_sumsq_emulation_covers_every_element_once(dtype):
    g = _leaves(dtype, 1)[0]
    visits = [torch.zeros(n, dtype=torch.int32) for n in SIZES]
    got = OR.sumsq_chunked_torch(g, visits)
    want = torch.stack(OR.sumsq_torch(g))
    assert got.dtype == f32 and got.shape == (len(SIZES),)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert float(got[SIZES.index(0)]) == 0.0
    assert all(bool((x == 1).all()) for x in visits)


def test_leaf_table_and_chunks():
    numels = list(SIZES)
    rows = OK.leaf_rows(numels, [1] * len(numels), list(range(10, 17)),
                        ptypes=[0] * len(numels))
    assert rows.shape == (len(numels), 8) and rows.dtype == np.int64
    first = OK.first_chunks(numels)
    assert rows[:, 0].tolist() == list(range(10, 17))
    assert rows[:, 4].tolist() == numels and rows[:, 7].tolist() == first
    assert first == [0, 1, 2, 2, 3, 4, 6]
    # every chunk: its leaf is the last whose first chunk is <= it, and
    # the chunks of a leaf tile it; the empty leaf owns none
    seen = {}
    for c in range(sum(OK.n_chunks(n) for n in numels)):
        leaf, start, count = OK.chunk_span(first, numels, c)
        assert 0 < count <= OK.CHUNK
        seen.setdefault(leaf, []).append((start, count))
    assert 2 not in seen
    for leaf, spans in seen.items():
        assert [s for s, _ in spans] == list(range(0, numels[leaf],
                                                   OK.CHUNK))
        assert sum(c for _, c in spans) == numels[leaf]


def test_kernel_constants_match_the_source():
    src = OK.SOURCE.read_text()
    assert f"constexpr int kThreads = {OK.THREADS};" in src
    assert f"constexpr long long kChunk = {OK.CHUNK};" in src
    assert f"constexpr int kGroup = {OK.GROUP};" in src
    assert f"constexpr int kMaxLeaves = {OK.MAX_LEAVES};" in src
    # the table goes by value: 64 B a row, inside a launch's 32 KB of
    # parameters with the rest of them (the source asserts 28 KB)
    assert "__grid_constant__ Table t" in src
    assert 64 * OK.MAX_LEAVES <= 28672
    # every f32 operation of the update rounded on its own
    assert "__fmaf" not in src and "fmaf(" not in src


# ------------------------------------------------------------ the step

@pytest.mark.parametrize("make", [lambda: adamw(lr=1e-2),
                                  lambda: adafactor(lr=1e-2)],
                         ids=["adamw", "adafactor"])
def test_step_advances_in_place(make):
    opt = make()
    p = _torch_tree(_np_tree(0, SHAPES))
    st = opt.init(p)
    step = st["step"]
    for s in range(2):
        _, st = opt.update(_torch_tree(_np_tree(1 + s, SHAPES)), st, p,
                           clip_scale=torch.tensor(0.5), impl="torch")
        assert st["step"] is step and int(step) == s + 1
        assert step.dtype == torch.int32 and step.shape == ()


def test_in_place_state_round_trips_with_repro(tmp_path):
    topt, jopt = adamw(lr=1e-2, **HYPER), jadamw(lr=1e-2, **HYPER)
    p0 = _np_tree(0, SHAPES)
    tp, ts = _torch_tree(p0), topt.init(_torch_tree(p0))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    for s in range(2):
        g = _np_tree(5 + s, SHAPES)
        tp, ts = topt.update(_torch_tree(g), ts, tp, lr_scale=0.5,
                             impl="torch")
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, lr_scale=0.5)
    # the port's checkpoint in repro: the step and the moments
    tckpt.save(str(tmp_path / "t"), 2, {"params": tp, "opt": ts})
    like = jax.tree.map(jnp.zeros_like, {"params": jp, "opt": js})
    back = jckpt.restore(str(tmp_path / "t"), 2, like)
    assert int(back["opt"]["step"]) == 2
    for k in SHAPES:
        np.testing.assert_allclose(np.asarray(back["opt"]["m"][k]),
                                   np.asarray(js["m"][k]), rtol=1e-6,
                                   atol=1e-12)
    # repro's checkpoint in the port, and one more in-place step on it
    jckpt.save(str(tmp_path / "j"), 2, {"params": jp, "opt": js})
    got = tckpt.restore(str(tmp_path / "j"), 2,
                        {"params": {k: torch.zeros_like(v)
                                    for k, v in tp.items()},
                         "opt": topt.init(_torch_tree(p0))})
    step = got["opt"]["step"]
    assert int(step) == 2 and step.dtype == torch.int32
    _, st = topt.update(_torch_tree(_np_tree(9, SHAPES)), got["opt"],
                        got["params"], impl="torch")
    assert st["step"] is step and int(step) == 3


def test_captured_train_step_raises_on_cpu_and_under_rules():
    model = build_model(tconfigs.smoke("llama3.2-1b"))
    opt = make_optimizer(model.cfg)
    with pytest.raises(ValueError, match="CUDA device"):
        CapturedTrainStep(model, opt, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        CapturedTrainStep(model, opt, rules=object(), device="cpu")


def test_cli_on_cpu_gives_the_eager_steps_losses(tmp_path):
    from repro_torch.data import DataPipeline
    steps, seed = 3, 2
    got = ttrain.main(["--smoke", "--device", "cpu", "--steps", str(steps),
                       "--batch", "2", "--seq", "16", "--ckpt-dir",
                       str(tmp_path), "--log-every", "1", "--seed",
                       str(seed)])
    cfg = tconfigs.smoke("llama3.2-1b")
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=3e-4)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    state = {"params": params, "opt": opt.init(params)}
    step = make_train_step(model, opt, peak_lr=3e-4, warmup=10,
                           total_steps=steps)
    it = DataPipeline(cfg=cfg, seq_len=16, global_batch=2,
                      seed=seed).iter_from(0)
    want = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
        state, m = step(state, batch)
        want.append(float(m["loss"]))
    assert got["losses"] == want


# ------------------------------------------------------- the card mocked

def test_cuda_call_without_a_library_raises(monkeypatch, tmp_path):
    # the card mocked: the wrappers take the kernel for these CPU tensors;
    # the library cannot be built (no nvcc), and nothing falls back
    monkeypatch.setattr(_grad, "on_card", lambda t: True)
    monkeypatch.setattr(OK, "_check", lambda *a: None)
    monkeypatch.setattr(OK, "_scalar", lambda *a: None)
    monkeypatch.setattr(OK, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    g, p, m, v = (list(x) for x in _leaves(torch.bfloat16, 2))
    before = [t.clone() for t in g + p + m + v]
    with pytest.raises(_build.KernelBuildError):
        OO.sumsq(g)
    with pytest.raises(_build.KernelBuildError):
        OO.global_norm(g, impl="cuda")
    with pytest.raises(_build.KernelBuildError):
        OO.adamw_update(g, p, m, v, scale=torch.tensor(0.5),
                        lr=torch.tensor(1e-3), bc1=torch.tensor(0.1),
                        bc2=torch.tensor(0.05), **HYPER)
    assert all(torch.equal(a, b) for a, b in zip(g + p + m + v, before))
    # the plain route stays open by asking for it
    assert len(OO.sumsq(g, impl="torch")) == len(g)


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_every_config_fits_one_launch(arch):
    # every leaf of a train state in one launch's table, at full depth
    # (the leaves are stacked by layer, so depth does not add rows)
    defs = build_model(tconfigs.get(arch)).defs
    n = len(tree_leaves(defs, is_def))
    assert 0 < n <= OK.MAX_LEAVES


def test_too_many_leaves_raise():
    with pytest.raises(ValueError, match=f"at most {OK.MAX_LEAVES}"):
        OK.sumsq_cuda([torch.ones(1)] * (OK.MAX_LEAVES + 1))


def test_cuda_impl_refuses_cpu_leaves():
    g = [torch.ones(3)]
    with pytest.raises(ValueError, match="CUDA"):
        OO.sumsq(g, impl="cuda")
    with pytest.raises(ValueError, match="unknown optimizer impl"):
        OO.sumsq(g, impl="xla")


# ------------------------------------------------------- costs, dry-run

def test_costs_against_hand_counts():
    # sumsq: each element read once (2 B in bf16, 4 in f32), one f32 out a
    # leaf, a square and a sum an element
    assert costs.sumsq_cost([10, 3], [2, 4]) == (26, 10 * 2 + 3 * 4 + 8)
    # the update: 22 B a bf16 parameter (g 2, p 2 + 2, m 4 + 4, v 4 + 4),
    # 28 B an f32 one, and the four f32 scalars; 17 operations a parameter
    assert costs.adamw_update_cost([10], [2], [2]) == (170, 220 + 16)
    assert costs.adamw_update_cost([10, 1], [4, 2], [4, 2]) == (
        187, 10 * 28 + 22 + 16)
    # llama3.2-1b at published width: ~0.74 ms and ~8.1 ms at 3.35 TB/s
    n = tconfigs.get("llama3.2-1b").param_count()
    _, b = costs.sumsq_cost([n], [2])
    assert 0.7 < b / costs.HBM_BYTES_PER_S * 1e3 < 0.8
    _, b = costs.adamw_update_cost([n], [2], [2])
    assert 8.0 < b / costs.HBM_BYTES_PER_S * 1e3 < 8.2


def test_dry_run_counts_the_two_ops_on_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    g, p, m, v = _leaves(torch.bfloat16, 3)
    scalars = [torch.tensor(x) for x in (0.5, 1e-3, 0.1, 0.05)]
    fake = FakeTensorMode()
    fg, fp, fm, fv = ([fake.from_tensor(t) for t in ts]
                      for ts in (g, p, m, v))
    fs = [fake.from_tensor(t) for t in scalars]
    mode = D.CostMode(fake)
    ops = torch.ops.repro_torch
    with fake, mode:
        sums = ops.sumsq(fg)
        ops.adamw_update(fg, fp, fm, fv, *fs, 0.9, 0.95, 1e-8, 0.1)
    assert tuple(sums.shape) == (len(SIZES),) and sums.dtype == f32
    assert mode.launches() == {"sumsq": 1, "adamw_update": 1}
    k = mode.kernels
    numels = list(SIZES)
    assert (k["sumsq"]["flops"], k["sumsq"]["bytes"]) == costs.sumsq_cost(
        numels, [2] * len(numels))
    assert (k["adamw_update"]["flops"], k["adamw_update"]["bytes"]) == \
        costs.adamw_update_cost(numels, [2] * len(numels), [2] * len(numels))
    assert k["sumsq"]["flop_class"] == k["adamw_update"]["flop_class"] \
        == "cuda_core"
    # nothing was written: the fake op only gives shapes
    assert all(torch.equal(a, b) for a, b in zip(p, _leaves(torch.bfloat16,
                                                            3)[1]))
