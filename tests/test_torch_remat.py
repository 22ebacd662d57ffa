"""``cfg.remat`` in the port's training forward, against ``repro``'s
``jax.checkpoint``, on the CPU.

  * loss and every gradient leaf bit-equal between ``remat="none"``,
    ``"block"`` and ``"dots"`` for the smoke config of each family (dense,
    MoE, MLA with MTP, RWKV-6, Griffin, encoder-decoder), in f32, and the
    wrapper where ``repro``'s ``_maybe_remat`` puts it: one checkpoint a
    block of the dense and MoE stacks, a RWKV-6 block, a Griffin group of
    ``pattern`` (the unrolled tail not wrapped), an encoder block and a
    decoder block;
  * ``"dots"`` against ``repro``'s ``loss_fn`` at the same setting, at
    ``test_torch_train.py``'s tolerances (loss 1e-5, each gradient leaf
    1e-4 of its largest) for the three families ``test_torch_train.py``
    holds at the default, ``"block"``, in both packages;
  * under ``torch.no_grad()`` prefill, decode and ``loss_fn`` make the same
    aten calls at every setting, and no checkpoint;
  * the products ``"dots"`` keeps in each block (each checkpoint's
    ``models/remat.py:_Store``) equal ``repro``'s residuals under
    ``dots_with_no_batch_dims_saveable`` (``saved_residuals`` of
    ``jax.checkpoint`` around the same block), by shape and count, the
    arguments left out; each shape as the matrix its product computes
    (``repro``'s ``(B, S, H, D)`` as ``(B * S, H * D)``, the port's ``bmm``
    output ``(1, B * S, H * D)`` the same);
  * with the card mocked (``test_torch_train.py``'s ``on_card``): the
    attention's forward runs twice a block under ``"block"`` and ``"dots"``
    (once more in the backward), once under ``"none"``, its backward once,
    with the same gradient; Griffin's RG-LRU and windowed attention
    backward once a layer under ``"block"`` and ``"dots"``, with the
    gradient of ``"none"``; RWKV-6's WKV-6 forward twice a layer and its
    backward once (``WKV6Fn``), loss and every gradient leaf bit-equal to
    ``"none"``'s.
"""

import collections
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models.layers import Ctx as JCtx  # noqa: E402
from repro.models.zoo import build_model as jax_build  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import remat as R  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    params_from_numpy,
    tree_leaves,
    tree_map,
)
from repro_torch.models.remat import einsum_has_batch_dims  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402

from test_torch_recurrent_models import live_leaves  # noqa: E402
from test_torch_train import on_card  # noqa: E402,F401

FAMILIES = ("llama3.2-1b", "granite-moe-3b-a800m", "deepseek-v3-671b",
            "rwkv6-7b", "recurrentgemma-2b", "seamless-m4t-medium")
POLICIES = ("none", "block", "dots")
B, S, SE = 2, 24, 12
f32 = jnp.float32


def _cfg(arch, remat):
    return dataclasses.replace(tconfigs.smoke(arch), remat=remat)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, SE, cfg.d_model)).astype(np.float32))
    return batch


def _grads(model, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(params, batch)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _wrapped(cfg) -> int:
    """The checkpoints ``repro``'s ``_maybe_remat`` puts in one forward."""
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.block_pattern)
    if cfg.is_encoder_decoder:
        return cfg.encoder_layers + cfg.n_layers
    return cfg.n_layers


@pytest.fixture(scope="module")
def runs():
    """Each family's loss, gradients, checkpoint count and kept products at
    each setting, from one f32 init and one batch."""
    out = {}
    for arch in FAMILIES:
        params = build_model(_cfg(arch, "none")).init(
            torch.Generator().manual_seed(0), "cpu")
        params = tree_map(lambda t: t.float(), params)
        batch = _batch(_cfg(arch, "none"))
        for pol in POLICIES:
            model = build_model(_cfg(arch, pol))
            calls, stores = [0], []
            real, real_store = zoo.checkpoint, R._Store

            def counted(*a, **kw):
                calls[0] += 1
                return real(*a, **kw)

            class Store(real_store):
                def __init__(self):
                    super().__init__()
                    stores.append(self)

            zoo.checkpoint, R._Store = counted, Store
            try:
                p = tree_map(lambda t: t.detach().clone(), params)
                loss, grads = _grads(model, p, batch)
            finally:
                zoo.checkpoint, R._Store = real, real_store
            # the products each checkpointed forward kept: mm / bmm outputs
            saved = [[tuple(t.shape) for t in st.saved if t is not None]
                     for st in stores]
            out[arch, pol] = dict(loss=loss, grads=grads, calls=calls[0],
                                  saved=saved)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("pol", ("block", "dots"))
def test_remat_bit_equal_to_none(runs, arch, pol):
    base, got = runs[arch, "none"], runs[arch, pol]
    assert torch.equal(got["loss"], base["loss"])
    assert len(got["grads"]) == len(base["grads"])
    for a, b in zip(got["grads"], base["grads"]):
        assert torch.equal(a, b)
    assert any(float(g.abs().max()) > 0 for g in got["grads"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_granularity(runs, arch):
    cfg = tconfigs.smoke(arch)
    assert runs[arch, "none"]["calls"] == 0
    for pol in ("block", "dots"):
        assert runs[arch, pol]["calls"] == _wrapped(cfg), pol
    assert len(runs[arch, "dots"]["saved"]) == _wrapped(cfg)
    assert runs[arch, "block"]["saved"] == []


def test_configs_default_to_block():
    for arch in tconfigs.ARCH_NAMES:
        assert tconfigs.get(arch).remat == jconfigs.get(arch).remat == \
            "block"


@pytest.mark.parametrize("eq,batch", [
    ("bsd,df->bsf", False), ("bsd,dhk->bshk", False),
    ("bshk,hkd->bsd", False), ("btfr,frd->btfd", True),
    ("xecd,edf->xecf", True), ("bshr,btr->bhst", True),
    ("bhst,btr->bshr", True), ("bsd,vd->bsv", False)])
def test_einsum_batch_dims(eq, batch):
    assert einsum_has_batch_dims(eq) is batch


# ------------------------------------------------------------ vs repro


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("arch", ("llama3.2-1b", "rwkv6-7b",
                                  "recurrentgemma-2b"))
def test_remat_matches_repro(arch, pol="dots"):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), remat=pol)
    jm, tm = jax_build(jcfg), build_model(_cfg(arch, pol))
    init = jm.init(jax.random.PRNGKey(0))
    jp = init if arch == "llama3.2-1b" else live_leaves(arch, init)
    jp = jax.tree.map(lambda a: a.astype(f32), jp)
    tp = tree_map(lambda t: t.float(),
                  params_from_numpy(tm.defs, _np32(jp), "cpu"))
    tokens = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jg = jax.value_and_grad(lambda p: jm.loss_fn(
        p, {"tokens": jnp.asarray(tokens)}, impl="xla")[0])(jp)
    tl, tg = _grads(tm, tp, {"tokens": torch.from_numpy(tokens)})
    assert abs(float(tl) - float(jl)) <= 1e-5
    for a, b in zip(jax.tree.leaves(jg), tg):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-12)
        assert float(np.abs(b.numpy() - a).max()) / scale <= 1e-4


# ------------------------------------------------------------ serving


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _serving_ops(arch, pol):
    cfg = _cfg(arch, pol)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg)
    batch["tokens"] = batch["tokens"][:1, :8]
    if "frames" in batch:
        batch["frames"] = batch["frames"][:1]
    calls, real = [0], zoo.checkpoint

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    zoo.checkpoint = counted
    try:
        with torch.no_grad(), _Ops() as rec:
            cache = model.init_cache(1, 12, "cpu")
            logits, cache = model.prefill_fn(params, cache, batch)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            for t in range(8, 11):
                logits, cache = model.decode_fn(params, cache, tok, t)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
            model.loss_fn(params, _batch(cfg))
    finally:
        zoo.checkpoint = real
    return rec.ops, calls[0], tok


@pytest.mark.parametrize("arch", FAMILIES)
def test_no_grad_paths_unchanged(arch):
    ops, calls, tok = _serving_ops(arch, "none")
    assert calls == 0
    for pol in ("block", "dots"):
        got_ops, got_calls, got_tok = _serving_ops(arch, pol)
        assert got_calls == 0, pol
        assert got_ops == ops, pol
        assert torch.equal(got_tok, tok)


# ------------------------------------------------------------ saved set

POL = jax.checkpoint_policies.dots_with_no_batch_dims_saveable


def _residual_shapes(f, *args):
    res = saved_residuals(jax.checkpoint(f, policy=POL), *args)
    return sorted(_rows_cols(tuple(a.shape)) for a, why in res
                  if "from the argument" not in why
                  and "from a constant" not in why)


def _jax_saved(arch) -> list:
    """``repro``'s residuals of each kind of wrapped body, in the order the
    port's forward runs them (one entry a kind)."""
    cfg = jconfigs.smoke(arch)
    p = jax.tree.map(lambda a: a.astype(f32),
                     jax_build(cfg).init(jax.random.PRNGKey(0)))
    D = cfg.d_model

    def pos(n):
        return jnp.broadcast_to(jnp.arange(n)[None], (B, n))

    ctx = JCtx(cfg=cfg, impl="xla", positions=pos(S))
    x = jnp.ones((B, S, D), f32)

    def first(t):
        return jax.tree.map(lambda a: a[0], t)

    if cfg.attn_free:
        return [_residual_shapes(
            lambda pl, x: JB.rwkv6_block_apply(pl, x, ctx, None)[0].sum(),
            first(p["blocks"]), x)]
    if cfg.family == "hybrid":
        g = p["groups"]

        def group(x):
            seen = {"rec": 0, "attn": 0}
            for b in cfg.block_pattern:
                fn = JB.griffin_rec_block_apply if b == "rec" else \
                    JB.griffin_attn_block_apply
                x = fn(jax.tree.map(lambda a: a[seen[b]], g[b]), x, ctx,
                       None)[0]
                seen[b] += 1
            return x.sum()

        return [_residual_shapes(group, x)]
    if cfg.is_encoder_decoder:
        ectx = JCtx(cfg=cfg, impl="xla", positions=pos(SE))
        xe = jnp.ones((B, SE, D), f32)
        return [
            _residual_shapes(
                lambda pl, x: JB.encoder_block_apply(pl, x, ectx).sum(),
                first(p["enc"]), xe),
            _residual_shapes(
                lambda pl, x, e: JB.decoder_block_apply(pl, x, ctx,
                                                        e)[0].sum(),
                first(p["dec"]), x, xe)]
    out = []
    for key, moe in (("dense", False), ("moe", True)):
        if key in p:
            def f(pl, x, moe=moe):
                y, _, aux = JB.transformer_block_apply(pl, x, ctx, None,
                                                       moe=moe)
                return y.sum() + aux
            out.append(_residual_shapes(f, first(p[key]), x))
    return out


def _rows_cols(shape):
    """A product's output as the matrix its ``mm`` / ``bmm`` computes:
    ``repro``'s ``(B, S, ...)`` as ``(B * S, the rest)``; the port's
    ``(1, rows, cols)`` (the one batch of an ``einsum``'s ``bmm``) as
    ``(rows, cols)``."""
    if len(shape) == 3 and shape[0] == 1:
        return shape[1:]
    if len(shape) > 2:
        return (shape[0] * shape[1], math.prod(shape[2:]))
    return tuple(shape)


@pytest.mark.parametrize("arch", FAMILIES)
def test_dots_saves_repro_residuals(runs, arch):
    cfg = tconfigs.smoke(arch)
    kinds = _jax_saved(arch)
    port = [sorted(_rows_cols(s) for s in call)
            for call in runs[arch, "dots"]["saved"]]
    if cfg.is_encoder_decoder:
        want = [kinds[0]] * cfg.encoder_layers + [kinds[1]] * cfg.n_layers
    elif len(kinds) == 2:                       # dense blocks, then MoE
        want = [kinds[0]] * cfg.n_dense_layers + [kinds[1]] * (
            cfg.n_layers - cfg.n_dense_layers)
    else:
        want = kinds * len(port)
    assert port == want
    # the products are there: the kept set is not empty for any block
    assert all(len(k) >= 5 for k in want)
    counts = collections.Counter(len(k) for k in port)
    assert sum(counts.values()) == _wrapped(cfg)


# ------------------------------------------------------------ mocked card


@pytest.mark.parametrize("pol", POLICIES)
def test_mock_card_attention_runs_again(on_card, monkeypatch,  # noqa: F811
                                        pol):
    fk = fa_ops._kernel
    counts = collections.Counter()
    for name in ("flash_attention_cuda", "flash_backward_cuda"):
        fn = getattr(fk, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(fk, name, counted)
    cfg = _cfg("llama3.2-1b", pol)
    model = build_model(cfg)
    params = tree_map(lambda t: t.float(), model.init(
        torch.Generator().manual_seed(0), "cpu"))
    loss, grads = _grads(model, params, _batch(cfg))
    L = cfg.n_layers
    assert counts["flash_attention_cuda"] == (L if pol == "none" else 2 * L)
    assert counts["flash_backward_cuda"] == L
    if pol != "none":
        base = _cfg("llama3.2-1b", "none")
        p0 = tree_map(lambda t: t.float(), build_model(base).init(
            torch.Generator().manual_seed(0), "cpu"))
        loss0, grads0 = _grads(build_model(base), p0, _batch(base))
        assert torch.equal(loss, loss0)
        assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


@pytest.mark.parametrize("pol", ("block", "dots"))
def test_mock_card_griffin_trains_under_remat(on_card,  # noqa: F811
                                              monkeypatch, pol):
    # the RG-LRU's and the windowed attention's backward kernels (their
    # plain versions on the mocked card) run once a layer under each
    # remat, and the gradient is the one without remat
    from repro_torch.kernels.rglru import kernel as rk
    fk = fa_ops._kernel
    counts = collections.Counter()
    for mod, name in ((fk, "flash_backward_cuda"),
                      (rk, "rglru_backward_cuda")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    runs = {}
    for p in ("none", pol):
        cfg = _cfg("recurrentgemma-2b", p)
        model = build_model(cfg)
        params = tree_map(lambda t: t.float(), model.init(
            torch.Generator().manual_seed(0), "cpu"))
        counts.clear()
        runs[p] = _grads(model, params, _batch(cfg))
        n_attn = cfg.n_layers // len(cfg.block_pattern) \
            * cfg.block_pattern.count("attn")
        assert counts == {"flash_backward_cuda": n_attn,
                          "rglru_backward_cuda": cfg.n_layers - n_attn}
    assert torch.equal(runs[pol][0], runs["none"][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[pol][1],
                                                 runs["none"][1]))


@pytest.mark.parametrize("arch", ("rwkv6-7b",))
@pytest.mark.parametrize("pol", ("block", "dots"))
def test_mock_card_recurrences_raise_under_remat(on_card,  # noqa: F811
                                                 monkeypatch, arch, pol):
    # The name is kept from when this held the raise; it now holds that
    # WKV-6 trains under remat: WKV6Fn's forward (its plain version on the
    # mocked card) runs twice a layer, its backward once, and the loss and
    # every gradient leaf are those of "none"
    from repro_torch.kernels.rwkv6 import kernel as wk
    counts = collections.Counter()
    for name in ("wkv6_cuda", "wkv6_backward_cuda"):
        fn = getattr(wk, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(wk, name, counted)
    runs = {}
    for p in ("none", pol):
        cfg = _cfg(arch, p)
        model = build_model(cfg)
        params = tree_map(lambda t: t.float(), model.init(
            torch.Generator().manual_seed(0), "cpu"))
        counts.clear()
        runs[p] = _grads(model, params, _batch(cfg))
        L = cfg.n_layers
        assert counts == {"wkv6_cuda": L if p == "none" else 2 * L,
                          "wkv6_backward_cuda": L}
    assert torch.equal(runs[pol][0], runs["none"][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[pol][1],
                                                 runs["none"][1]))
