"""The train step's clip and Adafactor update (``repro_torch/kernels/optim``,
``csrc/adafactor.cu``) against ``repro``, on the CPU.

* the plain update (``ref.adafactor_update_torch``, what the CPU and
  ``impl="torch"`` run) against ``repro``'s clip and
  ``repro.optim.adafactor.update`` over 5 updates, 1-D to 4-D leaves in
  f32: parameters atol 1e-6, state rtol 1e-6 (``test_torch_optim_data.py``'s
  optimizer tolerance);
* the kernels' tiles and summation order emulated in torch
  (``ref.adafactor_update_chunked_torch``) against the plain version within
  the chip's limits (``chip_smoke.ADAFACTOR_MOMENT_RTOL`` for each moment,
  ``ADAFACTOR_P_RTOL`` for each leaf's parameters against the update's
  size) at ragged leaves in f32 and bf16, and the sharded form of the
  moments (the raw sums, then the moments from them) bit-equal to the fused
  one;
* the tile table and the launches' geometry against the constants parsed
  from ``csrc/adafactor.cu``;
* the ops' costs against hand counts, and the dry-run's counting mode on
  fake tensors counting the new ops;
* the route: ``impl="cuda"`` refusing CPU leaves, a CUDA-tensor call whose
  library cannot be built raising with no plain fallback, and on a mocked
  card the optimizer's update going through the three kernels' wrappers
  once each.
"""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from repro.optim.adafactor import adafactor as jadafactor  # noqa: E402
from repro_torch.kernels import _build, _grad, costs  # noqa: E402
from repro_torch.kernels.optim import kernel as OK  # noqa: E402
from repro_torch.kernels.optim import ops as OO  # noqa: E402
from repro_torch.kernels.optim import ref as OR  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models.params import is_def, tree_leaves  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.optim import adafactor  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (  # noqa: E402
    ADAFACTOR_MOMENT_RTOL,
    ADAFACTOR_P_RTOL,
    ADAFACTOR_RAGGED,
    train_launches,
)

f32 = torch.float32

# 1-D to 4-D, a single row, a single column, more than a tile of rows (128)
# and of columns (256)
SHAPES = {"bias": (7,), "one": (1,), "w": (5, 6), "row": (1, 300),
          "col": (130, 1), "stack": (3, 4, 5), "deep": (2, 3, 4, 5)}


def _np_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# ------------------------------------------------------ parity with repro

def test_plain_update_with_the_clip_matches_repro_over_five_updates():
    kw = dict(lr=1e-2, weight_decay=0.1)
    jopt, topt = jadafactor(**kw), adafactor(**kw)
    p0 = _np_tree(0)
    jp, tp = {k: jnp.asarray(v) for k, v in p0.items()}, _torch_tree(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    for s in range(5):
        # the clip bites at the first updates (norms ~30, ~3), not later
        g = _np_tree(10 + s, scale=3.0 * 10.0 ** (1 - s))
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(x.astype(jnp.float32)))
                             for x in jax.tree.leaves(jg)))
        scale = jnp.minimum(1.0, 1.0 / jnp.maximum(gnorm, 1e-9))
        jg = jax.tree.map(lambda x: x * scale.astype(x.dtype), jg)
        jp, js = jopt.update(jg, js, jp, lr_scale=0.5 + 0.1 * s)
        tg = list(_torch_tree(g).values())
        tnorm = OO.global_norm(tg, impl="torch")
        tscale = torch.clamp(1.0 / torch.clamp(tnorm, min=1e-9), max=1.0)
        tp, ts = topt.update(dict(zip(SHAPES, tg)), ts, tp,
                             lr_scale=0.5 + 0.1 * s, clip_scale=tscale,
                             impl="torch")
    assert int(ts["step"]) == int(js["step"]) == 5
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    for a, b in zip(jax.tree.leaves(js), tree_leaves(ts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=0)


# ----------------------------------------------- the kernels' decomposition

def _leaves(shapes, dtype, seed, moment_scale=1e-12):
    gen = torch.Generator().manual_seed(seed)
    r = lambda s, k: torch.randn(s, generator=gen) * k  # noqa: E731
    g = [r(s, 1e-2).to(dtype) for s in shapes]
    p = [r(s, 2e-2).to(dtype) for s in shapes]
    m = lambda s: torch.rand(s, generator=gen) * moment_scale  # noqa: E731
    vs = [{"vr": m(s[:-1]), "vc": m(s[:-2] + s[-1:])} if len(s) >= 2
          else {"v": m(s)} for s in shapes]
    return g, p, vs


def _scalars(step):
    t = torch.tensor(float(step))
    return dict(scale=torch.tensor(0.37), lr=torch.tensor(3e-4),
                beta2=1.0 - t ** -0.8, eps=1e-30, clip_threshold=1.0,
                weight_decay=0.0)


def _readings(p, vs, pp, vp, before):
    mom = max(float(((v[k] - w[k]).abs() / w[k].abs()).max())
              for v, w in zip(vs, vp) for k in v)
    par = []
    for a, b, c in zip(p, pp, before):
        d = float((a.float() - b.float()).norm())
        step = float((b.float() - c.float()).norm())
        par.append(0.0 if d == 0 else d / step)
    return mom, max(par)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_order_emulation_within_the_chips_limits(dtype):
    shapes = list(ADAFACTOR_RAGGED)
    g, p, vs = _leaves(shapes, dtype, 0)
    pp, vp = [t.clone() for t in p], copy.deepcopy(vs)
    before = [t.clone() for t in p]
    for step in (3, 4):
        grads = _leaves(shapes, dtype, step)[0]
        kw = _scalars(step)
        OR.adafactor_update_chunked_torch(grads, p, vs, **kw)
        OR.adafactor_update_torch([t.clone() for t in grads], pp, vp, **kw)
        mom, par = _readings(p, vs, pp, vp, before)
        assert mom <= ADAFACTOR_MOMENT_RTOL, mom
        assert par <= ADAFACTOR_P_RTOL, par
        # the emulation reads the gradients and does not write them
        assert all(torch.equal(a, b) for a, b in
                   zip(grads, _leaves(shapes, dtype, step)[0]))
        before = [t.clone() for t in pp]
        p = [t.clone() for t in pp]
        vs = copy.deepcopy(vp)
    assert not all(torch.equal(a, b) for a, b in zip(p, _leaves(
        shapes, dtype, 0)[1]))


def test_sharded_moments_equal_the_fused_ones():
    # raw sums then the moments from them (the sharded route at world size
    # 1) give the fused launch's bits
    shapes = list(ADAFACTOR_RAGGED)
    g, _, vs = _leaves(shapes, torch.float32, 1, moment_scale=1e-4)
    states = OR.flat_states(vs)
    other = [t.clone() for t in states]
    beta2 = 1.0 - torch.tensor(5.0) ** -0.8
    _, vrsum = OR.adafactor_sums_emulated(g, states, scale=None,
                                          beta2=beta2, eps=1e-30)
    sums, empty = OR.adafactor_sums_emulated(g, other, scale=None,
                                             beta2=beta2, eps=1e-30,
                                             fused=False)
    _, tot = OK.adafactor_geometry(shapes)
    assert sums.shape == (tot.sums,) and empty.numel() == 0
    got = OR.adafactor_finish_emulated(sums, g, other, beta2=beta2)
    assert got.shape == (tot.mats,) and torch.equal(got, vrsum)
    assert all(torch.equal(a, b) for a, b in zip(states, other))


def test_a_leaf_of_no_element_is_skipped():
    # an empty shard (sharding can leave one) owns no tile
    shapes = [(3, 7), (0, 5), (0,), (9,)]
    g, p, vs = _leaves(shapes, torch.float32, 2)
    geos, tot = OK.adafactor_geometry(shapes)
    assert [x.tiles for x in geos] == [1, 0, 0, 1]
    assert geos[2].first_tile == geos[3].first_tile == 1
    pp, vp = [t.clone() for t in p], copy.deepcopy(vs)
    kw = _scalars(2)
    OR.adafactor_update_chunked_torch(g, p, vs, **kw)
    OR.adafactor_update_torch([t.clone() for t in g], pp, vp, **kw)
    for i in (0, 3):
        torch.testing.assert_close(p[i], pp[i], rtol=1e-6, atol=1e-9)


def test_geometry_tiles_every_element_once():
    shapes = list(ADAFACTOR_RAGGED) + [(40000,), (2, 129, 513)]
    geos, tot = OK.adafactor_geometry(shapes)
    tiles = rstrips = cstrips = mats = sums = 0
    for s, geo in zip(shapes, geos):
        assert (geo.first_tile, geo.first_rstrip, geo.first_cstrip,
                geo.first_mat, geo.sums) == (tiles, rstrips, cstrips, mats,
                                             sums)
        # the tiled layout holds each element once, the rest zeros
        x = torch.arange(1, geo.n + 1, dtype=torch.float64).reshape(s)
        t = OR._tiled(x, geo)
        assert t.shape == (geo.m, geo.n_rt, geo.n_ct, OK.TILE_ROWS,
                           OK.TILE_COLS)
        nz = t[t != 0]
        assert nz.numel() == geo.n and torch.equal(nz.sort().values,
                                                   x.reshape(-1))
        if len(s) < 2:          # 1-D: chunks of TILE_ROWS x TILE_COLS
            assert (geo.m, geo.c, geo.n_ct) == (1, OK.TILE_COLS, 1)
            assert geo.n_rt == -(-geo.n // (OK.TILE_ROWS * OK.TILE_COLS))
            assert geo.rstrips == geo.cstrips == geo.mats == 0
        else:
            assert geo.mats == geo.m == int(np.prod(s[:-2]))
            assert geo.n_sums == geo.m * (s[-2] + s[-1])
        tiles += geo.tiles
        rstrips += geo.rstrips
        cstrips += geo.cstrips
        mats += geo.mats
        sums += geo.n_sums
    assert (tot.tiles, tot.rstrips, tot.cstrips, tot.mats, tot.sums) == (
        tiles, rstrips, cstrips, mats, sums)


def test_leaf_table_rows():
    shapes = [(3, 700), (5,), (2, 3, 130, 300)]
    geos, _ = OK.adafactor_geometry(shapes)
    counts = OK.whole_counts(shapes)
    assert counts == [3, 700, 2100, 0, 0, 5, 130, 300, 234000]
    rows = OK.adafactor_rows(geos, [1, 0, 1], [11, 12, 13], [21, 22, 23],
                             [31, 0, 33], counts, p_addrs=[41, 42, 43],
                             ptypes=[1, 0, 0])
    assert rows.shape == (3, OK.ADAFACTOR_FIELDS) and rows.dtype == np.int64
    assert rows[:, 0].tolist() == [11, 12, 13]
    assert rows[:, 1].tolist() == [41, 42, 43]
    assert rows[:, 2].tolist() == [21, 22, 23]
    assert rows[:, 3].tolist() == [31, 0, 33]
    assert rows[:, 4].tolist() == [2100, 5, 234000]
    # flags: bit 0 g bf16, bit 1 p bf16, bit 2 factored
    assert rows[:, 8].tolist() == [1 | 2 | 4, 0, 1 | 4]
    assert rows[:, 9].tolist() == [g.first_tile for g in geos]
    # the means' counts: C low, R high; n
    assert rows[0, 16] == 700 | (3 << 32) and rows[2, 17] == 234000
    assert rows[2, 5:8].tolist() == [6, 130, 300]


def test_kernel_constants_match_the_source():
    src = OK.ADAFACTOR_SOURCE.read_text()
    assert f"constexpr int kThreads = {OK.THREADS};" in src
    assert f"constexpr int kGroup = {OK.GROUP};" in src
    assert f"constexpr int kTileRows = {OK.TILE_ROWS};" in src
    assert "constexpr int kTileCols = 32 * kGroup;" in src
    assert OK.TILE_COLS == 32 * OK.GROUP
    assert f"constexpr int kMaxLeaves = {OK.ADAFACTOR_MAX_LEAVES};" in src
    assert f"constexpr int kFields = {OK.ADAFACTOR_FIELDS};" in src
    for name, mode in OK.MODES.items():
        assert f"k{name.capitalize()} = {mode}" in src
    # the table goes by value: 144 B a row, inside a launch's 32 KB of
    # parameters with the rest of them (the source asserts 28 KB)
    assert "__grid_constant__ Table t" in src
    assert 8 * OK.ADAFACTOR_FIELDS * OK.ADAFACTOR_MAX_LEAVES <= 28672
    # every f32 operation rounded on its own; torch.rsqrt's rsqrtf
    assert "__fmaf" not in src and "fmaf(" not in src
    assert "rsqrtf(" in src and "__frsqrt_rn" not in src
    # no float atomics: the sums' order is fixed
    assert "atomicAdd(" in src and "atomicAdd(rowpart" not in src
    for line in src.splitlines():
        if "atomicAdd(" in line:
            assert "1u)" in line


@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_every_config_fits_one_adafactor_launch(arch):
    defs = build_model(tconfigs.get(arch)).defs
    n = len(tree_leaves(defs, is_def))
    assert 0 < n <= OK.ADAFACTOR_MAX_LEAVES


# ------------------------------------------------------- costs, dry-run

def test_costs_against_hand_counts():
    shapes, g, p = [(4, 6), (5,)], [2, 4], [2, 4]
    # the whole update: 6 B a bf16 parameter (g 2, p 2 + 2), 12 an f32
    # one, 8 B a moment (vr 4 + vc 6, v 5), the three scalars
    flops, nbytes = costs.adafactor_cost(shapes, g, p)
    assert nbytes == 24 * 6 + 5 * 12 + 8 * (4 + 6 + 5) + 12
    # the moments: g read, the moments read and written, a matrix's vrsum;
    # 5 operations an element and a moment of a factored leaf, 6 an
    # element of a 1-D one
    assert costs.adafactor_sums_cost(shapes, g) == (
        5 * 24 + 5 * 10 + 6 * 5, 24 * 2 + 8 * 10 + 4 + 5 * 4 + 8 * 5 + 4)
    # raw: the rows' and columns' sums written instead of the moments
    assert costs.adafactor_sums_cost(shapes, g, fused=False) == (
        5 * 24 + 6 * 5, 24 * 2 + 4 * 10 + 5 * 4 + 8 * 5 + 4)
    assert costs.adafactor_finish_cost(shapes) == (5 * 10,
                                                   12 * 10 + 4 + 4)
    assert costs.adafactor_rms_cost(shapes, g) == (
        5 * 29, 24 * 2 + 4 * 10 + 5 * 4 + 4 * 5 + 8)
    assert costs.adafactor_update_cost(shapes, g, p) == (
        8 * 29, 24 * 6 + 4 * 10 + 5 * 12 + 4 * 5 + 8 + 8)
    assert flops == sum(f(*a)[0] for f, a in (
        (costs.adafactor_sums_cost, (shapes, g)),
        (costs.adafactor_rms_cost, (shapes, g)),
        (costs.adafactor_update_cost, (shapes, g, p))))
    # deepseek-v3-671b at 3 layers + MTP: 4.29 G bf16 parameters, ~7.7 ms
    # at 3.35 TB/s (6 B a parameter); the norm ~2.56 ms
    cfg = tconfigs.cut_depth(tconfigs.get("deepseek-v3-671b"), 3)
    ds = [tuple(d.shape) for d in tree_leaves(build_model(cfg).defs,
                                              is_leaf=is_def)]
    n = sum(int(np.prod(s)) for s in ds)
    assert len(ds) == 31 and n == 4_290_066_432
    _, b = costs.adafactor_cost(ds, [2] * 31, [2] * 31)
    assert 7.68 < b / costs.HBM_BYTES_PER_S * 1e3 < 7.71
    _, b = costs.sumsq_cost([int(np.prod(s)) for s in ds], [2] * 31)
    assert 2.55 < b / costs.HBM_BYTES_PER_S * 1e3 < 2.57


def test_dry_run_counts_the_new_ops_on_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    shapes = list(ADAFACTOR_RAGGED)
    g, p, vs = _leaves(shapes, torch.bfloat16, 3)
    states = OR.flat_states(vs)
    scalars = [torch.tensor(x) for x in (0.5, 0.4, 1e-3)]
    fake = FakeTensorMode()
    fg, fp, fs = ([fake.from_tensor(t) for t in ts] for ts in (g, p, states))
    scale, beta2, lr = (fake.from_tensor(t) for t in scalars)
    counts = OK.whole_counts(shapes)
    mode = D.CostMode(fake)
    ops = torch.ops.repro_torch
    _, tot = OK.adafactor_geometry(shapes)
    with fake, mode:
        sums, vrsum = ops.adafactor_sums(fg, fs, scale, beta2, 1e-30, counts,
                                         OK.MODES["fused"])
        u2sum = ops.adafactor_rms(fg, fs, vrsum, scale, 1e-30, counts)
        ops.adafactor_update(fg, fp, fs, vrsum, u2sum, scale, lr, 1e-30,
                             1.0, 0.0, counts)
        raw, _ = ops.adafactor_sums(fg, fs, scale, beta2, 1e-30, counts,
                                    OK.MODES["raw"])
        again = ops.adafactor_finish(raw, fg, fs, beta2, counts)
    assert tuple(sums.shape) == (0,) and tuple(vrsum.shape) == (tot.mats,)
    assert tuple(raw.shape) == (tot.sums,) and again.shape == vrsum.shape
    assert tuple(u2sum.shape) == (len(shapes),) and u2sum.dtype == f32
    # the finishing launch is adafactor_sums_kernel's too
    assert mode.launches() == {"adafactor_sums": 3, "adafactor_rms": 1,
                               "adafactor_update": 1}
    k = mode.kernels
    es = [2] * len(shapes)
    assert (k["adafactor_rms"]["flops"], k["adafactor_rms"]["bytes"]) == \
        costs.adafactor_rms_cost(shapes, es)
    assert (k["adafactor_update"]["flops"],
            k["adafactor_update"]["bytes"]) == \
        costs.adafactor_update_cost(shapes, es, es)
    assert (k["adafactor_finish"]["flops"],
            k["adafactor_finish"]["bytes"]) == \
        costs.adafactor_finish_cost(shapes)
    fused, raw_cost = (costs.adafactor_sums_cost(shapes, es, fused=f)
                       for f in (True, False))
    assert k["adafactor_sums"]["flops"] == fused[0] + raw_cost[0]
    assert all(v["flop_class"] == "cuda_core" for v in k.values())
    # nothing was written: the fake ops only give shapes
    assert all(torch.equal(a, b) for a, b in zip(
        p, _leaves(shapes, torch.bfloat16, 3)[1]))


def test_train_launches_count_the_adafactor_kernels():
    cfg = tconfigs.cut_depth(tconfigs.get("deepseek-v3-671b"), 3)
    got = train_launches(cfg, steps=2)
    assert {k: got[k] for k in ("sumsq", "adafactor_sums", "adafactor_rms",
                                "adafactor_update")} == dict.fromkeys(
        ("sumsq", "adafactor_sums", "adafactor_rms", "adafactor_update"), 2)
    assert "adamw_update" not in got
    assert adafactor.fused_clip


# ------------------------------------------------------------ the route

def test_cuda_impl_refuses_cpu_leaves():
    g, p, vs = _leaves([(3, 4), (5,)], torch.float32, 4)
    with pytest.raises(ValueError, match="CUDA"):
        OO.adafactor_update(g, p, vs, impl="cuda", **_scalars(2))
    with pytest.raises(ValueError, match="unknown optimizer impl"):
        OO.adafactor_update(g, p, vs, impl="xla", **_scalars(2))


def test_cuda_call_without_a_library_raises(monkeypatch, tmp_path):
    # the card mocked: the wrappers take the kernels for these CPU tensors;
    # the library cannot be built (no nvcc), and nothing falls back
    monkeypatch.setattr(_grad, "on_card", lambda t: True)
    monkeypatch.setattr(OK, "_check", lambda *a: None)
    monkeypatch.setattr(OK, "_scalar", lambda *a: None)
    monkeypatch.setattr(OK, "_adafactor_lib", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    g, p, vs = _leaves([(3, 4), (5,)], torch.bfloat16, 5)
    before = [t.clone() for t in g + p + OR.flat_states(vs)]
    with pytest.raises(_build.KernelBuildError):
        OO.adafactor_update(g, p, vs, **_scalars(2))
    opt = adafactor(lr=1e-2)
    state = opt.init(dict(zip("ab", p)))
    with pytest.raises(_build.KernelBuildError):
        opt.update(dict(zip("ab", g)), state, dict(zip("ab", p)),
                   clip_scale=torch.tensor(0.5))
    assert all(torch.equal(a, b) for a, b in
               zip(g + p + OR.flat_states(vs), before))
    # the plain route stays open by asking for it
    OO.adafactor_update(g, p, vs, impl="torch", **_scalars(2))


def test_update_takes_the_three_kernels_on_a_mocked_card(monkeypatch):
    # the card mocked, each wrapper its emulation with a count: the
    # optimizer's update is one launch of each kernel, the gradients are
    # read and not written, and the result is within the chip's limits of
    # the plain update
    calls = {}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(_grad, "on_card", lambda t: True)
    for name, fn in (("adafactor_sums_cuda", OR.adafactor_sums_emulated),
                     ("adafactor_finish_cuda", OR.adafactor_finish_emulated),
                     ("adafactor_rms_cuda", OR.adafactor_rms_emulated),
                     ("adafactor_update_cuda",
                      OR.adafactor_update_emulated)):
        monkeypatch.setattr(OK, name, counted(name, fn))
    tree = {k: torch.from_numpy(v) for k, v in _np_tree(6, 2e-2).items()}
    grads = {k: torch.from_numpy(v) for k, v in _np_tree(7, 1e-2).items()}
    opt = adafactor(lr=1e-2)
    st, ref = opt.init(tree), opt.init(tree)
    ref_tree = {k: v.clone() for k, v in tree.items()}
    g_before = {k: v.clone() for k, v in grads.items()}
    scale = torch.tensor(0.5)
    opt.update(grads, st, tree, clip_scale=scale)
    assert calls == {"adafactor_sums_cuda": 1, "adafactor_rms_cuda": 1,
                     "adafactor_update_cuda": 1}
    assert all(torch.equal(grads[k], g_before[k]) for k in grads)
    opt.update({k: v.clone() for k, v in grads.items()}, ref, ref_tree,
               clip_scale=scale, impl="torch")
    mom, par = _readings([tree[k] for k in SHAPES],
                         [st["v"][k] for k in SHAPES],
                         [ref_tree[k] for k in SHAPES],
                         [ref["v"][k] for k in SHAPES],
                         [torch.from_numpy(v) for v in _np_tree(6, 2e-2)
                          .values()])
    assert mom <= ADAFACTOR_MOMENT_RTOL and par <= ADAFACTOR_P_RTOL
    assert int(st["step"]) == 1


def test_train_launches_count_the_split_route_under_rules():
    # under rules the moments take two launches of adafactor_sums_kernel
    # (the raw sums, then the moments once reduced); AdamW's count stays
    cfg = tconfigs.cut_depth(tconfigs.get("deepseek-v3-671b"), 1)
    got = train_launches(cfg, steps=3, rules=True)
    assert {k: got[k] for k in ("sumsq", "adafactor_sums", "adafactor_rms",
                                "adafactor_update")} == dict(
        sumsq=3, adafactor_sums=6, adafactor_rms=3, adafactor_update=3)
    llama = tconfigs.get("llama3.2-1b")
    assert train_launches(llama, 2, rules=True) == train_launches(llama, 2)


def test_split_route_gives_the_fused_routes_bits_on_a_mocked_card(
        monkeypatch):
    # the card mocked, each wrapper its emulation with a count: on plain
    # tensors the split route (sharded leaves' route, nothing to reduce)
    # launches the sums kernel twice and leaves the fused route's bits
    calls = {}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    for name, fn in (("adafactor_sums_cuda", OR.adafactor_sums_emulated),
                     ("adafactor_finish_cuda", OR.adafactor_finish_emulated),
                     ("adafactor_rms_cuda", OR.adafactor_rms_emulated),
                     ("adafactor_update_cuda",
                      OR.adafactor_update_emulated)):
        monkeypatch.setattr(OK, name, counted(name, fn))
    shapes = list(ADAFACTOR_RAGGED)
    g, p, vs = _leaves(shapes, torch.bfloat16, 8)
    ps, vss = [t.clone() for t in p], copy.deepcopy(vs)
    kw = _scalars(3)
    OO.adafactor_kernels(g, p, vs, split=False, **kw)
    assert calls == {"adafactor_sums_cuda": 1, "adafactor_rms_cuda": 1,
                     "adafactor_update_cuda": 1}
    calls.clear()
    OO.adafactor_kernels(g, ps, vss, split=True, **kw)
    assert calls == {"adafactor_sums_cuda": 1, "adafactor_finish_cuda": 1,
                     "adafactor_rms_cuda": 1, "adafactor_update_cuda": 1}
    assert all(torch.equal(a, b) for a, b in zip(p, ps))
    assert all(torch.equal(a, b) for a, b in zip(OR.flat_states(vs),
                                                 OR.flat_states(vss)))
    assert not all(torch.equal(a, b) for a, b in zip(
        p, _leaves(shapes, torch.bfloat16, 8)[1]))
