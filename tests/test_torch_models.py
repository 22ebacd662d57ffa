"""The port's dense decoder LM against ``repro``'s on ``llama3.2-1b``'s
smoke config.

JAX-initialized parameters are carried across with ``params_from_numpy``
(bf16 travels exactly as float32); prompts are made with numpy from a
seed.  Both packages run prefill and then decode steps against a cache:

  * in f32 (params and caches of both cast to f32): logits allclose at
    atol 1e-4 (sums in another order, through 2 layers);
  * in bf16, as served: logits allclose at atol 2e-2 and greedy tokens
    equal (JAX's own bf16-vs-f32 gap on this config is about 4e-3, against
    top-1/top-2 margins of 0.02-0.06).

``rms_norm``, ``apply_rope`` and ``mlp_apply`` are also held alone in f32.
"""

import functools
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.zoo import build_model as jax_build  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    ParamDef,
    params_from_numpy,
    stack_defs,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.models.zoo import build_model  # noqa: E402

ARCH = "llama3.2-1b"
P, STEPS, SMAX = 8, 4, 16


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jconfigs.smoke(ARCH))
    tm = build_model(tconfigs.smoke(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(
        tm.defs, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        "cpu")
    return jm, tm, jp, tp


def _run_jax(jm, params, cache, prompt, forced=None):
    prefill = jax.jit(functools.partial(jm.prefill_fn, impl="xla"))
    decode = jax.jit(functools.partial(jm.decode_fn, impl="xla"))
    logits, cache = prefill(params, cache, {"tokens": jnp.asarray(prompt)})
    out, toks = [np.asarray(logits)], [np.asarray(jnp.argmax(logits, -1))]
    for s in range(STEPS):
        tok = toks[-1] if forced is None else forced[s]
        logits, cache = decode(params, cache,
                               jnp.asarray(tok, jnp.int32)[:, None],
                               jnp.int32(P + s))
        out.append(np.asarray(logits))
        toks.append(np.asarray(jnp.argmax(logits, -1)))
    return out, toks


def _run_port(tm, params, cache, prompt, forced=None):
    logits, cache = tm.prefill_fn(
        params, cache, {"tokens": torch.from_numpy(prompt).long()})
    out, toks = [logits.numpy()], [logits.argmax(-1).numpy()]
    for s in range(STEPS):
        tok = torch.tensor(np.asarray(toks[-1] if forced is None
                                      else forced[s])).long()
        logits, cache = tm.decode_fn(params, cache, tok[:, None], P + s)
        out.append(logits.numpy())
        toks.append(logits.argmax(-1).numpy())
    return out, toks


def _prompt(seed, B=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (B, P)).astype(np.int32)


def test_param_tree_maps_one_to_one(models):
    jm, tm, jp, tp = models
    jl_, _ = jax.tree.flatten(jp)
    assert [tuple(a.shape) for a in jl_] == \
        [tuple(t.shape) for t in tree_leaves(tp)]
    for a, t in zip(jl_, tree_leaves(tp)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      t.float().numpy())
    assert tm.cfg.param_count() == jm.cfg.param_count()


def test_tree_order_is_jax_order():
    tree = {"b": {"z": 1, "a": [2, 3]}, "a": (4, None, 5), "c": 6}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree) == [4, 5, 2, 3, 1, 6]
    assert tree_unflatten(treedef, leaves) == {
        "a": (4, None, 5), "b": {"a": [2, 3], "z": 1}, "c": 6}
    defs = stack_defs({"w": ParamDef((3, 4), (None, "tensor"))}, 5)
    assert defs["w"].shape == (5, 3, 4) and defs["w"].scale_axis == 1


def test_tree_helpers_leave_no_reference_cycle():
    """Flattening and rebuilding a tree of tensors leaves nothing that
    holds them once the caller drops them, with the garbage collector off:
    a decode state's tensors are freed at once."""
    tree = {"k": torch.zeros(4), "v": [torch.ones(2), (torch.ones(3),)]}
    leaves, treedef = tree_flatten(tree)
    refs = [weakref.ref(t) for t in leaves]
    gc.collect()
    gc.disable()
    try:
        rebuilt = tree_unflatten(treedef, tree_map(lambda t: t, tree_leaves(
            tree_unflatten(treedef, leaves))))
        assert all(a is b for a, b in zip(tree_leaves(rebuilt), leaves))
        del tree, leaves, rebuilt
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


@pytest.mark.parametrize("seed", [1, 2])
def test_prefill_and_decode_logits_f32(models, seed):
    jm, tm, jp, tp = models
    prompt = _prompt(seed)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    jc = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jm.init_cache(2, SMAX))
    tp32 = tree_map(lambda t: t.float(), tp)
    tc = tree_map(lambda t: t.float(), tm.init_cache(2, SMAX, "cpu"))
    want, toks = _run_jax(jm, jp32, jc, prompt)
    got, _ = _run_port(tm, tp32, tc, prompt, forced=toks)
    for s, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32 and g.shape == (2, 512)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4,
                                   err_msg=f"step {s}")


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_prefill_and_decode_bf16_as_served(models, seed):
    jm, tm, jp, tp = models
    prompt = _prompt(seed)
    want, want_toks = _run_jax(jm, jp, jm.init_cache(2, SMAX), prompt)
    got, got_toks = _run_port(tm, tp, tm.init_cache(2, SMAX, "cpu"), prompt)
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-2,
                                   err_msg=f"step {s}")
    np.testing.assert_array_equal(np.stack(got_toks), np.stack(want_toks))


def test_cache_written_in_place(models):
    _, tm, _, tp = models
    cache = tm.init_cache(1, SMAX, "cpu")
    k = cache["dense"]["k"]
    _, out = tm.prefill_fn(tp, cache, {"tokens": torch.ones(1, P).long()})
    assert out["dense"]["k"] is k
    assert k[:, :, :P].abs().sum() > 0 and k[:, :, P:].abs().sum() == 0


def test_rms_norm_f32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    s = rng.standard_normal(64).astype(np.float32) * 0.1
    want = jl.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(s)})
    got = tl.rms_norm(torch.from_numpy(x), {"scale": torch.from_numpy(s)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_f32(theta):
    # positions up to 4096: one f32 ulp of the angle there is 4.9e-4, and
    # XLA's and torch's exp/sin/cos may differ by an ulp, so the rotated
    # values (|x| < 4) may differ by 4 * 4.9e-4; near position 0 by 1e-5
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    pos = np.stack([np.arange(9), 4096 - np.arange(9)[::-1]])
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0],
                               rtol=0, atol=1e-5)


def test_mlp_apply_f32():
    cfg = tconfigs.smoke(ARCH)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    p = {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[0]))
         .astype(np.float32) for k, d in tl.mlp_defs(cfg).items()}
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jconfigs.smoke(ARCH))
    got = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_unported_families_raise():
    """Once the families ROADMAP A7 waited for (it raised for them): the
    encoder-decoder, MLA and MTP now build, with ``repro``'s top-level
    parameter and cache keys; and the MoE decoder and the recurrent
    families build as before."""
    import dataclasses

    from repro.configs.base import MLAConfig as JMLAConfig
    from repro_torch.configs.base import MLAConfig

    cfg, jcfg = tconfigs.smoke(ARCH), jconfigs.smoke(ARCH)
    dims = dict(q_lora_rank=16, kv_lora_rank=16, qk_nope_head_dim=8,
                qk_rope_head_dim=8, v_head_dim=8)
    for new, jnew in ((dict(is_encoder_decoder=True, encoder_layers=1),) * 2,
                      (dict(mla=MLAConfig(**dims)),
                       dict(mla=JMLAConfig(**dims))),
                      (dict(mtp=True),) * 2):
        tm = build_model(dataclasses.replace(cfg, **new))
        jm = jax_build(dataclasses.replace(jcfg, **jnew))
        assert set(tm.defs) == set(jm.defs), new
        assert set(tm.make_cache_defs(1, 8)) == set(jm.make_cache_defs(1, 8))
        is_leaf = lambda d: hasattr(d, "logical")
        assert [tuple(d.shape) for d in jax.tree.leaves(
            jm.defs, is_leaf=is_leaf)] == [tuple(d.shape) for d in
                                           tree_leaves(tm.defs,
                                                       is_leaf=is_leaf)]
    # the MoE decoder builds now (ROADMAP A7's MoE part): every layer an
    # MoE block unless n_dense_layers leads with dense ones
    moe = dataclasses.replace(cfg, n_experts=4, n_experts_per_tok=2,
                              moe_d_ff=32)
    assert set(build_model(moe).defs) == {"embed", "moe", "ln_f"}
    both = build_model(dataclasses.replace(moe, n_dense_layers=1))
    assert set(both.defs) == {"embed", "dense", "moe", "ln_f"}
    assert set(both.make_cache_defs(1, 8)) == {"dense", "moe"}
    # the recurrent families (ROADMAP A5) build now: RWKV-6 and Griffin
    rwkv = build_model(dataclasses.replace(cfg, attn_free=True))
    griffin = build_model(dataclasses.replace(cfg, family="hybrid"))
    assert set(rwkv.defs) == {"embed", "blocks", "ln_f"}
    assert set(griffin.defs) == {"embed", "groups", "tail", "ln_f"}
