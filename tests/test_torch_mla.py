"""The port's MLA decoder with the MTP head (``deepseek-v3-671b``) against
``repro``'s, on the CPU.

JAX-initialized parameters are carried across with ``params_from_numpy``;
inputs are made with numpy from a seed.  In f32 at atol 1e-5 unless
stated:

  * ``mla_apply``: the expanded prefill (through the flash attention at
    (D, Dv) = (nope + rope, v) with its own softmax scale) and the
    absorbed decode over several steps, at an int position, a 0-d tensor
    one and a ``(B,)`` one (bit-equal to the int's, row by row); the
    latent caches equal ``repro``'s after every write, and bit-equal to
    what the port's own projections give, at exactly the written rows;
  * the MLA transformer block, dense and MoE;
  * the smoke model's logits through ``prefill_fn`` and 4 ``decode_fn``
    steps and the decode state after them, ``loss_fn`` with its metrics
    (``mtp_loss`` and ``aux_loss`` among them) and every gradient leaf
    within 1e-4 of the leaf's largest (the MTP block's included);
  * the parameter tree, ``mtp`` included, maps one to one;
  * the full config's decode plan at smax 1056 integer-equal to
    ``repro``'s (arena, resident extent, transients, every offset);
  * the port's ``DecodeServer`` against ``repro``'s, serial and
    ``step_mode="vmap"``: the pool's integers exactly, the served tokens
    bit-equal to the port's arena-free loop (serial) and equal to
    ``repro``'s up to a first divergence at a step whose reference top-1
    margin is within the bf16 noise (``TIE``).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import blocks as jb  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.params import init_params as jinit  # noqa: E402
from repro.models.zoo import build_model as jax_build  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core import plan_shared_arena  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import blocks as tb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    params_from_numpy,
    tree_leaves,
    tree_map,
)
from repro_torch.models.zoo import build_model  # noqa: E402
from test_torch_serve import (  # noqa: E402
    METRICS,
    _assert_plans_equal,
    _port_direct,
    _reference_margins,
)

ARCH = "deepseek-v3-671b"
ATOL = 1e-5
P, STEPS = 8, 4
# a reference top-1 margin within llama3.2-1b's bf16 logit tolerance is a
# tie that rounding (or the router, on the same noise) may break either way
TIE = 5e-2


def _np32(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jconfigs.smoke(ARCH))
    tm = build_model(tconfigs.smoke(ARCH))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tp = params_from_numpy(tm.defs, _np32(jp), "cpu")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    return jm, tm, jp, tp, jp32, tree_map(lambda t: t.float(), tp)


def _params(defs, rng):
    def leaf(d):
        scale = 0.1 if d.init == "zeros" else d.shape[d.scale_axis] ** -0.5
        return (rng.standard_normal(d.shape) * scale).astype(np.float32)
    return tree_map(leaf, defs, is_leaf=lambda d: hasattr(d, "logical"))


def _jax_mla(p, x, cache, pos, t, decode):
    ctx = jl.Ctx(cfg=jconfigs.smoke(ARCH), impl="xla", decode=decode,
                 positions=pos, cache_len=t)
    return jl.mla_apply(p, x, ctx, cache)


_jax_mla = jax.jit(_jax_mla, static_argnums=(5,))


def _ctxs(B, S, decode=False, t=0):
    pos = t + np.arange(S)[None].repeat(B, 0)
    jctx = jl.Ctx(cfg=jconfigs.smoke(ARCH), impl="xla", decode=decode,
                  positions=jnp.asarray(pos), cache_len=t)
    tctx = tl.Ctx(cfg=tconfigs.smoke(ARCH), impl="torch", decode=decode,
                  positions=torch.from_numpy(pos), cache_len=t)
    return jctx, tctx


def _tensor_ctx(B, t):
    """A decode context at a 0-d tensor position (``t`` an int) or a
    ``(B,)`` one (``t`` a list)."""
    cfg = tconfigs.smoke(ARCH)
    if isinstance(t, list):
        tt = torch.tensor(t)
        return tl.Ctx(cfg=cfg, impl="torch", decode=True, cache_len=tt,
                      positions=tt[:, None],
                      rows=torch.arange(B)[:, None])
    tt = torch.tensor(t)
    return tl.Ctx(cfg=cfg, impl="torch", decode=True, cache_len=tt,
                  positions=torch.full((B, 1), t))


def test_mla_prefill_and_absorbed_decode():
    cfg = tconfigs.smoke(ARCH)
    m = cfg.mla
    rng = np.random.default_rng(1)
    B, S, Smax = 2, 6, 12
    p = _params(tl.mla_defs(cfg), rng)
    jp_, tp_ = jax.tree.map(jnp.asarray, p), tree_map(torch.from_numpy, p)
    shapes = {"ckv": (B, Smax, m.kv_lora_rank),
              "krope": (B, Smax, m.qk_rope_head_dim)}
    jc = {k: jnp.zeros(s) for k, s in shapes.items()}
    tc = {k: torch.zeros(s) for k, s in shapes.items()}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jctx, tctx = _ctxs(B, S)
    want, jc = _jax_mla(jp_, jnp.asarray(x), jc, jctx.positions, 0, False)
    got, tc = tl.mla_apply(tp_, torch.from_numpy(x), tctx, tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)

    def own_latents(x, ctx):
        dkv = torch.einsum("bsd,dr->bsr", x, tp_["w_dkv"])
        ckv = tl.rms_norm(dkv[..., :m.kv_lora_rank], tp_["kv_norm"])
        kr = tl.apply_rope(dkv[..., m.kv_lora_rank:][:, :, None],
                           ctx.positions, cfg.rope_theta)[:, :, 0]
        return ckv, kr

    ckv, kr = own_latents(torch.from_numpy(x), tctx)
    assert torch.equal(tc["ckv"][:, :S], ckv)
    assert torch.equal(tc["krope"][:, :S], kr)
    assert float(tc["ckv"][:, S:].abs().max()) == 0.0
    for s in range(3):
        t = S + s
        y = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jctx, tctx = _ctxs(B, 1, decode=True, t=t)
        want, jc = _jax_mla(jp_, jnp.asarray(y), jc, jctx.positions,
                            jnp.int32(t), True)
        # the same step at a 0-d and at a (B,) tensor position, on copies
        # of the cache, bit-equal to the int position's
        alt = [tl.mla_apply(tp_, torch.from_numpy(y), _tensor_ctx(B, pos),
                            {k: v.clone() for k, v in tc.items()})
               for pos in (t, [t] * B)]
        got, tc = tl.mla_apply(tp_, torch.from_numpy(y), tctx, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"step {s}")
        for a, ac in alt:
            assert torch.equal(a, got)
            for k in tc:
                assert torch.equal(ac[k], tc[k]), k
        ckv, kr = own_latents(torch.from_numpy(y), tctx)
        assert torch.equal(tc["ckv"][:, t:t + 1], ckv)
        assert torch.equal(tc["krope"][:, t:t + 1], kr)
        for k in tc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=0, atol=ATOL, err_msg=k)
        assert float(tc["ckv"][:, t + 1:].abs().max()) == 0.0


def test_mla_rows_at_own_positions_match_rows_alone():
    cfg = tconfigs.smoke(ARCH)
    m = cfg.mla
    rng = np.random.default_rng(2)
    B, Smax, starts = 3, 10, [2, 5, 7]
    p = tree_map(torch.from_numpy, _params(tl.mla_defs(cfg), rng))
    ckv = torch.from_numpy(rng.standard_normal(
        (B, Smax, m.kv_lora_rank)).astype(np.float32))
    kr = torch.from_numpy(rng.standard_normal(
        (B, Smax, m.qk_rope_head_dim)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32))
    cache = {"ckv": ckv.clone(), "krope": kr.clone()}
    got, cache = tl.mla_apply(p, y, _tensor_ctx(B, starts), cache)
    for b, t in enumerate(starts):
        one = {"ckv": ckv[b:b + 1].clone(), "krope": kr[b:b + 1].clone()}
        _, tctx = _ctxs(1, 1, decode=True, t=t)
        want, one = tl.mla_apply(p, y[b:b + 1], tctx, one)
        assert torch.allclose(got[b:b + 1], want, atol=ATOL, rtol=0)
        for k in one:
            # the written row in batch-B and batch-1 products; the rest
            # untouched
            assert torch.allclose(cache[k][b:b + 1], one[k], atol=ATOL,
                                  rtol=0), k
            keep = torch.ones(Smax, dtype=torch.bool)
            keep[t] = False
            assert torch.equal(cache[k][b, keep], one[k][0, keep]), k


@pytest.mark.parametrize("moe", [False, True])
def test_mla_transformer_block(moe):
    cfg = tconfigs.smoke(ARCH)
    rng = np.random.default_rng(3)
    B, S = 2, 5
    # repro's own init in f32, the experts' leaves (scaled by the expert
    # count there) rescaled by their fan-in, so that the block's output
    # stays O(1)
    p = _np32(jinit(jb.transformer_block_defs(jconfigs.smoke(ARCH), moe=moe),
                    jax.random.PRNGKey(3)))
    if moe:
        for k in ("wi_gate", "wi_up", "wo"):
            w = p["mlp"][k]
            p["mlp"][k] = w * (w.shape[0] / w.shape[1]) ** 0.5
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jctx, tctx = _ctxs(B, S)
    want, _, jaux = jax.jit(lambda p, x: jb.transformer_block_apply(
        p, x, jctx, moe=moe))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got, _, taux = tb.transformer_block_apply(
        tree_map(torch.from_numpy, p), torch.from_numpy(x), tctx, moe=moe)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert abs(float(taux) - float(jaux)) <= ATOL


def test_param_tree_maps_one_to_one(models):
    jm, tm, jp, tp, _, _ = models
    assert set(tp) == set(jp) == {"embed", "dense", "moe", "mtp", "ln_f"}
    assert set(tp["mtp"]) == {"proj", "block", "ln"}
    assert set(tp["dense"]["attn"]) == set(tl.mla_defs(tm.cfg))
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    assert tm.cfg.param_count() == jm.cfg.param_count()


def test_smoke_logits_and_state_match_repro_f32(models):
    jm, tm, _, _, jp, tp = models
    B, smax = 2, P + STEPS
    prompt = np.random.default_rng(4).integers(0, 512, (B, P)).astype(
        np.int32)
    jcache = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init_cache(B, smax))
    tcache = tree_map(lambda t: t.float(), tm.init_cache(B, smax, "cpu"))
    assert set(tcache["dense"]) == {"ckv", "krope"}
    prefill = jax.jit(functools.partial(jm.prefill_fn, impl="xla"))
    decode = jax.jit(functools.partial(jm.decode_fn, impl="xla"))
    want, jcache = prefill(jp, jcache, {"tokens": jnp.asarray(prompt)})
    got, tcache = tm.prefill_fn(tp, tcache,
                                {"tokens": torch.from_numpy(prompt).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg="prefill")
    for s in range(STEPS):
        tok = np.asarray(jnp.argmax(want, -1))[:, None]
        want, jcache = decode(jp, jcache, jnp.asarray(tok, jnp.int32),
                              jnp.int32(P + s))
        got, tcache = tm.decode_fn(tp, tcache, torch.tensor(tok).long(),
                                   P + s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"step {s}")
    for a, b in zip(jax.tree.leaves(jcache), tree_leaves(tcache)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)


def test_smoke_loss_and_grads_match_repro_f32(models):
    jm, tm, _, _, jp, tp = models
    tokens = np.random.default_rng(5).integers(0, 512, (2, 10)).astype(
        np.int32)
    jloss = lambda p: jm.loss_fn(p, {"tokens": jnp.asarray(tokens)},
                                 impl="xla")
    (_, jmet), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    tp = tree_map(lambda t: t.clone(), tp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tloss, tmet = tm.loss_fn(tp, {"tokens": torch.from_numpy(tokens)})
    tg = torch.autograd.grad(tloss, leaves)
    assert set(tmet) == set(jmet) == {"loss", "lm_loss", "aux_loss",
                                      "mtp_loss"}
    for k in jmet:
        assert abs(float(tmet[k].detach()) - float(jmet[k])) <= ATOL, k
    # the MTP loss counts: 0.3 of it is in the loss
    got = {k: float(v.detach()) for k, v in tmet.items()}
    assert abs(got["loss"] - got["lm_loss"] - 0.01 * got["aux_loss"]
               - 0.3 * got["mtp_loss"]) <= ATOL
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-12)
        assert float(np.abs(b.numpy() - a).max()) / scale <= 1e-4, a.shape
    # the MTP block's gradient is not zero
    mtp = tree_leaves(tp["mtp"])
    assert all(float(g.abs().max()) > 0 for g, p in zip(tg, leaves)
               if any(p is q for q in mtp) and p.dim() > 1)


# arena, resident extent, transients, buffers at smax 1056 (1024 prompt +
# 32 generated): the full config, and the depth cut that chip_smoke.py
# serves (its A7 table holds the same integers)
PLANS = {61: (74_753_028, 74_207_236, 545_792, 190),
         4: (5_411_844, 4_866_052, 545_792, 19)}


@pytest.mark.parametrize("n_layers", sorted(PLANS))
def test_decode_plan_equal_full_config_at_1056(n_layers):
    import dataclasses

    jcfg = dataclasses.replace(jconfigs.get(ARCH), n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.get(ARCH), n_layers=n_layers)
    jp = jserve.plan_decode_arena(jax_build(jcfg), 1, 1056)
    tp = tserve.plan_decode_arena(build_model(tcfg), 1, 1056)
    _assert_plans_equal(jp, tp)
    assert (tp["arena_bytes"], tp["resident_extent"], tp["transient_bytes"],
            tp["n_buffers"]) == PLANS[n_layers]
    # the dense stack's ckv and krope (3 layers), then the MoE stack's:
    # 576 latent values a token and layer
    n_moe = n_layers - 3
    assert tp["n_cache"] == 4
    assert [tp["graph"].sizes[i] for i in range(4)] == \
        [3 * 1056 * 512 * 2, 3 * 1056 * 64 * 2, n_moe * 1056 * 512 * 2,
         n_moe * 1056 * 64 * 2]


# a top-K margin of the router (the K-th minus the (K+1)-th probability)
# within bf16's rounding of it is a routing tie: a flip there swaps an
# expert's output for another's, beyond any logit tolerance
ROUTE_TIE = 3e-2


def _route_margins(tm, tp, prompt, tokens, monkeypatch):
    """The smallest router top-K margin over the forwards that lead to each
    of ``tokens`` in the port's arena-free loop fed ``tokens``: prefill for
    token 0, then the decode steps, cumulative (a flip moves every later
    logit)."""
    seen, out = [], []
    orig = tl.moe_dispatch

    def dispatch(probs, cfg, cf):
        top = torch.topk(probs, cfg.n_experts_per_tok + 1, dim=-1).values
        seen.append(float((top[..., -2] - top[..., -1]).min()))
        return orig(probs, cfg, cf)

    monkeypatch.setattr(tl, "moe_dispatch", dispatch)
    n = len(prompt)
    cache = tm.init_cache(1, n + len(tokens), "cpu")
    tm.prefill_fn(tp, cache, {"tokens": torch.as_tensor(prompt).long()[None]})
    for s, tok in enumerate(tokens):
        out.append(min(seen))
        tm.decode_fn(tp, cache, torch.tensor([[tok]]), n + s)
    monkeypatch.setattr(tl, "moe_dispatch", orig)
    return out


@pytest.mark.parametrize("step_mode", ["serial", "vmap"])
def test_server_matches_repro(models, step_mode, monkeypatch):
    jm, tm, jp, tp, _, _ = models
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
        if step_mode == "serial":
            assert list(b.tokens) == _port_direct(tm, tp, b.prompt, GEN)
        margins = _reference_margins(jm, jp, a.prompt, list(a.tokens),
                                     *steps)
        for s, m in enumerate(margins):
            if b.tokens[s] != a.tokens[s]:
                # a tie of the logits, or of the router on the way here
                route = _route_margins(tm, tp, b.prompt, list(b.tokens),
                                       monkeypatch)[s]
                assert m <= TIE or route <= ROUTE_TIE, (a.rid, s, m, route)
                break
            compared += 1
    assert compared >= len(jreqs) * GEN // 2, compared
