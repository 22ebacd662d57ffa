"""The port's encoder-decoder (``seamless-m4t-medium``) against ``repro``'s,
on the CPU, and the split-K decode's plain versions at a length on the
device.

JAX-initialized parameters are carried across with ``params_from_numpy``;
inputs are made with numpy from a seed.  ``repro``'s encoder cannot run
with f32 parameters (its layer scan carries the frames' bf16 and the
first block returns f32), so its f32 runs here round the frames to bf16
and carry them in f32, through ``repro.models.zoo.shard_act`` (the identity
without sharding rules) patched to cast to f32: what the port's encoder
does with f32 parameters.  In f32 at atol 1e-5 unless stated:

  * ``attn_apply`` as cross-attention over a padded ``kv_src`` with
    ``kv_src_len`` an int, a 0-d tensor and one per row (each row against
    ``repro``'s row alone at its length), and as non-causal
    self-attention;
  * ``encoder_block_apply`` and ``decoder_block_apply`` (its self cache
    written at prefill and at a decode step);
  * the smoke model's logits through ``prefill_fn`` and 4 ``decode_fn``
    steps and the decode state after them (``enc_len`` exactly), and
    ``loss_fn`` with its metrics, and every gradient leaf within 1e-4 of
    the leaf's largest;
  * ``decode_fn`` at a ``(B,)`` position with a ``(B,)`` ``enc_len`` (the
    batched step's tree, ``init_batched_cache``) against each row decoded
    alone;
  * the full config's decode plan at smax 1056 integer-equal to
    ``repro``'s (arena, resident extent, transients, every offset);
  * the port's ``DecodeServer`` against ``repro``'s, serial and
    ``step_mode="vmap"``, ``repro``'s frames injected through the port's
    ``encoder_frames`` (monkeypatched): the pool's integers exactly, the
    served tokens bit-equal to the port's arena-free loop and equal to
    ``repro``'s up to a first divergence at a step whose reference top-1
    margin is within the bf16 noise (``TIE``);
  * the split-K decode's plain partials and merge with ``kv_len`` on the
    device (0-d, and ``(B,)`` with lengths that cut a split in the
    middle) against ``attention_ref`` and ``repro``'s ``_flash_xla`` (each
    row alone at its length).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.models.zoo as jzoo  # noqa: E402
from repro.kernels.flash_attention.ops import _flash_xla  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.zoo import build_model as jax_build  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core import plan_shared_arena  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    flash_attention,
    flash_decode_combine_torch,
    flash_decode_partials_torch,
)
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    batch_axes,
    init_batched_cache,
)
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    params_from_numpy,
    tree_leaves,
    tree_map,
)
from repro_torch.models.zoo import build_model  # noqa: E402
from test_torch_serve import METRICS, _assert_plans_equal  # noqa: E402

ARCH = "seamless-m4t-medium"
ATOL = 1e-5
P, SE, STEPS = 8, 6, 4           # prompt tokens, frames, decode steps
# a reference top-1 margin within llama3.2-1b's bf16 logit tolerance is a
# tie that rounding may break either way
TIE = 5e-2


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture
def f32_encoder(monkeypatch):
    """``repro``'s encoder carried in f32 from the bf16-rounded frames."""
    monkeypatch.setattr(jzoo, "shard_act",
                        lambda x, rules, kind: x.astype(jnp.float32))


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jconfigs.smoke(ARCH))
    tm = build_model(tconfigs.smoke(ARCH))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm.defs, _np32(jp), "cpu")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jm, tm, jp, tp, jp32, tree_map(lambda t: t.float(), tp)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_params(cfg, rng):
    return {k: _rand(rng, *d.shape, scale=d.shape[0] ** -0.5)
            for k, d in tl.attn_defs(cfg, cross=True).items()}


def _ctx(cfg, B, S, decode=False, t=0, **kw):
    pos = t + np.arange(S)[None].repeat(B, 0)
    jctx = jl.Ctx(cfg=jconfigs.smoke(ARCH), impl="xla", decode=decode,
                  positions=jnp.asarray(pos), cache_len=t)
    tctx = tl.Ctx(cfg=cfg, impl="torch", decode=decode,
                  positions=torch.from_numpy(pos), cache_len=t, **kw)
    return jctx, tctx


# ------------------------------------------------ attention and blocks

@pytest.mark.parametrize("length", ["int", "0-d", "per_row"])
def test_cross_attention_over_a_padded_buffer(length):
    cfg = tconfigs.smoke(ARCH)
    rng = np.random.default_rng(1)
    B, S, Smax, D = 3, 2, 11, cfg.d_model
    p = _attn_params(cfg, rng)
    x, src = _rand(rng, B, S, D), _rand(rng, B, Smax, D)
    lens = [7, 3, 11] if length == "per_row" else [5] * B
    kv_len = {"int": 5, "0-d": torch.tensor(5, dtype=torch.int32),
              "per_row": torch.tensor(lens, dtype=torch.int32)}[length]
    _, tctx = _ctx(cfg, B, S)
    got, _ = tl.attn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), tctx,
                           kv_src=torch.from_numpy(src), kv_src_len=kv_len,
                           causal=False, use_rope=False)
    for b in range(B):
        jctx, _ = _ctx(cfg, 1, S)
        want, _ = jl.attn_apply({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x[b:b + 1]), jctx,
                                kv_src=jnp.asarray(src[b:b + 1]),
                                kv_src_len=jnp.int32(lens[b]), causal=False,
                                use_rope=False)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want),
                                   rtol=0, atol=ATOL, err_msg=str(b))
    # the padded rows are read: without the length the result moves
    full, _ = tl.attn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), tctx,
                            kv_src=torch.from_numpy(src), causal=False,
                            use_rope=False)
    assert float((full - got).abs().max()) > 1e-2


def test_non_causal_self_attention():
    cfg = tconfigs.smoke(ARCH)
    rng = np.random.default_rng(2)
    B, S = 2, 9
    p = _attn_params(cfg, rng)
    x = _rand(rng, B, S, cfg.d_model)
    jctx, tctx = _ctx(cfg, B, S)
    want, _ = jl.attn_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jctx, causal=False)
    got, _ = tl.attn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), tctx, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    causal, _ = tl.attn_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x), tctx)
    assert float((causal - got).abs().max()) > 1e-2


def _block_params(defs, rng):
    def leaf(d):
        if d.init == "zeros":
            return _rand(rng, *d.shape, scale=0.1)
        return _rand(rng, *d.shape, scale=d.shape[d.scale_axis] ** -0.5)
    return tree_map(leaf, defs, is_leaf=lambda d: hasattr(d, "logical"))


def test_encoder_and_decoder_blocks():
    cfg = tconfigs.smoke(ARCH)
    rng = np.random.default_rng(3)
    B, S, Smax, D = 2, 5, 9, cfg.d_model
    pe = _block_params(tb.encoder_block_defs(cfg), rng)
    pd = _block_params(tb.decoder_block_defs(cfg), rng)
    x, enc = _rand(rng, B, S, D), _rand(rng, B, 7, D)
    jt = lambda t: jax.tree.map(jnp.asarray, t)
    tt = lambda t: tree_map(torch.from_numpy, t)
    jctx, tctx = _ctx(cfg, B, S)
    want = jb.encoder_block_apply(jt(pe), jnp.asarray(x), jctx)
    got = tb.encoder_block_apply(tt(pe), torch.from_numpy(x), tctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # prefill into the self cache, then one decode step against it, the
    # encoder buffer padded past its 7 valid rows
    shape = (B, Smax, cfg.n_kv_heads, cfg.head_dim)
    jc = {"self": {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}}
    tc = {"self": {"k": torch.zeros(shape), "v": torch.zeros(shape)}}
    want, jc, _ = jb.decoder_block_apply(jt(pd), jnp.asarray(x), jctx,
                                         jnp.asarray(enc), jc)
    got, tc, _ = tb.decoder_block_apply(tt(pd), torch.from_numpy(x), tctx,
                                        torch.from_numpy(enc), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    pad = np.concatenate([enc, _rand(rng, B, 2, D)], 1)
    y = _rand(rng, B, 1, D)
    jctx, tctx = _ctx(cfg, B, 1, decode=True, t=S)
    want, jc, _ = jb.decoder_block_apply(
        jt(pd), jnp.asarray(y), jctx, jnp.asarray(pad), jc,
        enc_len=jnp.int32(7))
    got, tc, _ = tb.decoder_block_apply(
        tt(pd), torch.from_numpy(y), tctx, torch.from_numpy(pad), tc,
        enc_len=torch.tensor(7, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["self"][k].numpy(),
                                   np.asarray(jc["self"][k]), rtol=0,
                                   atol=ATOL)


# ------------------------------------------------ the model

def _batch(seed, B, S, Se, V, D):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, Se, D)).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(tokens).long(),
             "frames": torch.from_numpy(frames)})



def test_smoke_logits_and_state_match_repro_f32(models, f32_encoder):
    jm, tm, _, _, jp, tp = models
    B, smax = 2, P + STEPS
    jbatch, tbatch = _batch(4, B, P, SE, 512, 64)
    jcache = jax.tree.map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        jm.init_cache(B, smax))
    tcache = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                      tm.init_cache(B, smax, "cpu"))
    prefill = jax.jit(functools.partial(jm.prefill_fn, impl="xla"))
    decode = jax.jit(functools.partial(jm.decode_fn, impl="xla"))
    want, jcache = prefill(jp, jcache, jbatch)
    got, tcache = tm.prefill_fn(tp, tcache, tbatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg="prefill")
    assert int(tcache["enc_len"]) == SE and tcache["enc_len"].dtype == \
        torch.int32
    for s in range(STEPS):
        tok = np.asarray(jnp.argmax(want, -1))[:, None]
        want, jcache = decode(jp, jcache, jnp.asarray(tok, jnp.int32),
                              jnp.int32(P + s))
        got, tcache = tm.decode_fn(tp, tcache, torch.tensor(tok).long(),
                                   P + s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"step {s}")
    jleaves, tleaves = jax.tree.leaves(jcache), tree_leaves(tcache)
    assert [a.shape for a in jleaves] == [tuple(t.shape) for t in tleaves]
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)
    # the padded rows of the encoder buffer stay zero
    assert float(tcache["enc_out"][:, SE:].abs().max()) == 0.0


def test_smoke_loss_and_grads_match_repro_f32(models, f32_encoder):
    jm, tm, _, _, jp, tp = models
    jbatch, tbatch = _batch(5, 2, 10, SE, 512, 64)
    jloss = lambda p: jm.loss_fn(p, jbatch, impl="xla")
    (jloss_v, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = tree_map(lambda t: t.clone(), tp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss, tmet = tm.loss_fn(tp, tbatch)
    tg = torch.autograd.grad(tloss, leaves)
    assert set(tmet) == set(jmet) == {"loss", "lm_loss"}
    for k in jmet:
        assert abs(float(tmet[k].detach()) - float(jmet[k])) <= ATOL, k
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-12)
        assert float(np.abs(b.numpy() - a).max()) / scale <= 1e-4, a.shape
    assert max(float(np.abs(np.asarray(a)).max()) for a in jleaves) > 1e-3


def test_decode_at_row_positions_matches_rows_alone(models):
    """The batched step's tree: a (B,) position and a (B,) enc_len, each
    row prefilled alone with its own prompt and frames."""
    _, tm, _, _, _, tp = models
    smax, lens, frames = 16, [8, 5, 3], [6, 2, 4]
    B = len(lens)
    batched = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                       init_batched_cache(tm, B, smax))
    assert tuple(batched["enc_len"].shape) == (B,)
    axes = batch_axes(tm, smax)
    rows, toks = [], []
    for b, (n, se) in enumerate(zip(lens, frames)):
        _, tbatch = _batch(10 + b, 1, n, se, 512, 64)
        c = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                     tm.init_cache(1, smax, "cpu"))
        logits, c = tm.prefill_fn(tp, c, tbatch)
        for ax, dst, one in zip(axes, tree_leaves(batched), tree_leaves(c)):
            dst.narrow(ax, b, 1).copy_(one)
        rows.append(c)
        toks.append(int(logits.argmax(-1)))
    assert batched["enc_len"].tolist() == frames
    for s in range(3):
        got, batched = tm.decode_fn(tp, batched, torch.tensor(toks)[:, None],
                                    torch.tensor([n + s for n in lens]))
        for b in range(B):
            want, rows[b] = tm.decode_fn(tp, rows[b],
                                         torch.tensor([[toks[b]]]),
                                         lens[b] + s)
            assert torch.allclose(got[b:b + 1], want, atol=ATOL, rtol=0)
            toks[b] = int(want.argmax(-1))


def test_decode_plan_equal_full_config_at_1056():
    jp = jserve.plan_decode_arena(jax_build(jconfigs.get(ARCH)), 1, 1056)
    tp = tserve.plan_decode_arena(build_model(tconfigs.get(ARCH)), 1, 1056)
    _assert_plans_equal(jp, tp)
    # as chip_smoke.py's A7 table holds them
    assert (tp["arena_bytes"], tp["resident_extent"], tp["transient_bytes"],
            tp["n_buffers"]) == (55_096_128, 54_067_208, 1_028_920, 43)
    # enc_len (4 bytes), enc_out, then the self cache's k and v
    assert tp["n_cache"] == 4
    assert [tp["graph"].sizes[i] for i in range(4)] == \
        [4, 1056 * 1024 * 2] + [12 * 1056 * 16 * 64 * 2] * 2


# ------------------------------------------------ the server

def _jax_frames(rid, n, d):
    """``repro``'s server's frames for request ``rid`` (a writable copy)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(rid), (1, n, d),
                                      jnp.float32))


def _margins(jm, jp, prompt, frames, tokens, prefill, decode):
    """``repro``'s arena-free top-1 minus top-2 logit at each step."""
    n = len(prompt)
    cache = jm.init_cache(1, n + len(tokens))
    logits, cache = prefill(jp, cache, {
        "tokens": jnp.asarray(prompt, jnp.int32)[None],
        "frames": jnp.asarray(frames)})
    out = []
    for s, tok in enumerate(tokens):
        top2 = np.sort(np.asarray(logits, np.float32)[0])[-2:]
        out.append(float(top2[1] - top2[0]))
        logits, cache = decode(jp, cache, jnp.full((1, 1), tok, jnp.int32),
                               jnp.int32(n + s))
    return out


def _port_direct(tm, tp, prompt, frames, gen):
    """The port's arena-free greedy loop (the cache kept as tensors)."""
    n = len(prompt)
    cache = tm.init_cache(1, n + gen, "cpu")
    logits, cache = tm.prefill_fn(tp, cache, {
        "tokens": torch.as_tensor(prompt).long()[None],
        "frames": torch.from_numpy(frames)})
    toks = [int(logits.argmax(-1))]
    for s in range(gen - 1):
        logits, cache = tm.decode_fn(tp, cache, torch.tensor([[toks[-1]]]),
                                     n + s)
        toks.append(int(logits.argmax(-1)))
    return toks


def test_encoder_frames_are_seeded_by_rid():
    a = tserve.encoder_frames(3, 5, 8, "cpu")
    assert a.shape == (1, 5, 8) and a.dtype == torch.float32
    assert torch.equal(a, tserve.encoder_frames(3, 5, 8, "cpu"))
    assert not torch.equal(a, tserve.encoder_frames(4, 5, 8, "cpu"))


@pytest.mark.parametrize("step_mode", ["serial", "vmap"])
def test_server_matches_repro(models, monkeypatch, step_mode):
    jm, tm, jp, tp, _, _ = models
    monkeypatch.setattr(tserve, "encoder_frames",
                        lambda rid, n, d, device: _jax_frames(rid, n, d))
    GEN = 4
    smax = P + GEN
    plan = tserve.plan_decode_arena(tm, 1, smax)
    budget = plan_shared_arena([plan["plan"]] * 3).arena_bytes \
        if step_mode == "serial" else 4 * plan["arena_bytes"]
    kw = dict(smax=smax, budget_bytes=budget, warm=2, step_mode=step_mode)
    jreqs = jserve.synth_requests(6, P, GEN, 512, seed=1)
    treqs = tserve.synth_requests(6, P, GEN, 512, seed=1)
    jm_ = jserve.run_server(jm, jp, jreqs, **kw)
    tm_ = tserve.run_server(tm, tp, treqs, device="cpu", **kw)
    assert tm_["max_concurrent"] < 6        # the budget queued
    for k in METRICS:
        assert tm_[k] == jm_[k], k
    steps = [jax.jit(functools.partial(f, impl="xla"))
             for f in (jm.prefill_fn, jm.decode_fn)]
    compared = 0
    for a, b in zip(jreqs, treqs):
        assert (a.rid, a.rejected) == (b.rid, b.rejected)
        frames = _jax_frames(a.rid, P, 64)
        if step_mode == "serial":
            assert list(b.tokens) == _port_direct(tm, tp, b.prompt, frames,
                                                  GEN), b.rid
        margins = _margins(jm, jp, a.prompt, frames, list(a.tokens), *steps)
        for s, m in enumerate(margins):
            if b.tokens[s] != a.tokens[s]:
                assert m <= TIE, (a.rid, s, m)
                break
            compared += 1
    assert compared >= len(jreqs) * GEN // 2, compared


# ------------------------------------------------ the split-K decode's plain
# versions at a length on the device

@pytest.mark.parametrize("per_row", [False, True])
def test_plain_split_decode_at_device_kv_len(per_row):
    rng = np.random.default_rng(8)
    B, H, KV, D, Skv = 4, 8, 2, 16, 200
    q = _rand(rng, B, 1, H, D)
    k, v = _rand(rng, B, Skv, KV, D), _rand(rng, B, Skv, KV, D)
    # lengths that end inside a split (tiles of 32 keys, several a split)
    lens = [1, 45, 117, 200] if per_row else [77] * B
    kv = torch.tensor(lens if per_row else lens[0], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    S, tpc = FK.capacity_splits(B, KV, 1, H, D, Skv=Skv, causal=False,
                                window=None, splits=3)
    m, l, acc = flash_decode_partials_torch(tq, tk, tv, splits=3,
                                            causal=False, kv_len=kv)
    assert tuple(m.shape) == (B, KV, S, 1, H // KV) and S == 3
    assert any(n % (tpc * FK.DECODE_TILE) for n in lens)
    split = flash_decode_combine_torch(m, l, acc)
    rule = flash_decode_combine_torch(*flash_decode_partials_torch(
        tq, tk, tv, causal=False, kv_len=kv))
    plain = flash_attention(tq, tk, tv, causal=False, kv_len=kv,
                            impl="torch", kv_chunk=64)
    ref = attention_ref(tq, tk, tv, causal=False, kv_len=kv)
    for b, n in enumerate(lens):
        want = np.asarray(_flash_xla(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), causal=False, window=None, q_start=0,
            kv_len=jnp.int32(n), softmax_scale=None, kv_chunk=64,
            skip_masked_blocks=True))
        for got in (split, rule, plain, ref):
            np.testing.assert_allclose(got[b:b + 1].numpy(), want, rtol=0,
                                       atol=ATOL, err_msg=f"row {b}")
    # a split wholly past a row's length is empty: m = -inf, l = acc = 0
    if per_row:
        assert bool(torch.isinf(m[0, :, 1:]).all())
        assert float(l[0, :, 1:].abs().max()) == 0.0
