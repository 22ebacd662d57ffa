"""The port's MoE layer and the five decoder configs of this slice against
``repro``, on the CPU.

  * ``moe_apply`` at ``granite-moe-3b-a800m``'s smoke config, with the
    config's capacity factor (nothing dropped) and at 0.5 (tokens
    dropped): the dispatch integers -- ``expert_idx``, the keep mask and
    ``dest`` of every slot, and the capacity -- equal to those of
    ``repro``'s dispatch lines run in JAX (``src/repro/models/layers.py``,
    ``moe_apply``: top-k, stable argsort, bincount, rank, drop slot),
    outputs and the aux loss within 1e-5 in f32 (sums in another order);
  * the per-row dispatch (``per_row=True``, what the batched decode step
    asks for) against ``jax.vmap`` of ``repro``'s ``moe_apply`` over the
    rows, each a batch-1 call with its own capacity, at a batch where one
    joint dispatch drops a token (so the two would differ);
  * the capacity rule's Python ``round`` (half to even) at its ties;
  * ``params_from_numpy`` carries ``repro``'s MoE tree across, the router
    leaf in f32 while the rest is bf16, bit for bit;
  * the smoke logits (prefill and two decode steps) and ``loss_fn``
    (``loss``, ``lm_loss`` and ``aux_loss``) of the five archs --
    ``granite-moe-3b-a800m``, ``gemma-7b``, ``starcoder2-7b``,
    ``granite-20b``, ``chameleon-34b`` -- against ``repro``'s
    ``impl="xla"`` in f32 (params and caches cast to f32 in both), within
    1e-5, the parameters carried from ``repro``'s init;
  * a config with leading dense layers and MoE layers (``n_dense_layers``)
    keeps both stacks, in ``repro``'s parameter and cache trees.

Inputs are made with numpy from a seed.
"""

import dataclasses
import functools

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
    params_from_numpy,
    tree_leaves,
    tree_map,
)
from repro_torch.models.zoo import build_model  # noqa: E402

MOE = "granite-moe-3b-a800m"
ARCHS = (MOE, "gemma-7b", "starcoder2-7b", "granite-20b", "chameleon-34b")
ATOL = 1e-5            # f32: sums in another order
P, STEPS = 8, 2


def _moe_params(cfg, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(d.shape) / np.sqrt(d.shape[-2]))
            .astype(np.float32) for k, d in tl.moe_defs(cfg).items()}


def _jax_dispatch(p, x, cfg, cf):
    """The dispatch lines of ``repro``'s ``moe_apply``, run in JAX:
    (expert_idx, keep, dest, cap) of its slots."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    N = B * S
    xt = x.reshape(N, D)
    logits = (xt.astype(jnp.float32) @ p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, K)
    flat_e = expert_idx.reshape(-1)
    sort_idx = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    counts = jnp.bincount(flat_e, length=E)
    group_start = jnp.cumsum(counts) - counts
    rank = jnp.arange(N * K) - group_start[sorted_e]
    cap = min(max(8, int(round(N * K / E * cf / 8)) * 8), N)
    keep = rank < cap
    dest = jnp.where(keep, sorted_e * cap + rank, E * cap)
    return (np.asarray(expert_idx), np.asarray(keep), np.asarray(dest), cap)


def _port_dispatch(p, x, cfg, cf, per_row=False):
    B, S, D = x.shape
    G = B if per_row else 1
    xt = torch.from_numpy(x).reshape(G, B * S // G, D)
    probs = torch.softmax(xt @ torch.from_numpy(p["router"]), dim=-1)
    _, expert_idx, dest, keep, _, _, cap = tl.moe_dispatch(probs, cfg, cf)
    return expert_idx.numpy(), keep.numpy(), dest.numpy(), cap


@pytest.mark.parametrize("cf", [None, 0.5])
def test_moe_apply_matches_repro(cf):
    jcfg, tcfg = jconfigs.smoke(MOE), tconfigs.smoke(MOE)
    p = _moe_params(tcfg, 0)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    cf_ = tcfg.moe_capacity_factor if cf is None else cf
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = _jax_dispatch(jp, jnp.asarray(x), jcfg, cf_)
    got = _port_dispatch(p, x, tcfg, cf_)
    np.testing.assert_array_equal(got[0][0], want[0])
    np.testing.assert_array_equal(got[1][0], want[1])
    np.testing.assert_array_equal(got[2][0], want[2])
    assert got[3] == want[3]
    # the config's factor keeps every slot; 0.5 drops some
    assert want[1].all() == (cf is None)
    yj, aj = jl.moe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    yt, at = tl.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), tcfg, capacity_factor=cf)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=ATOL)
    assert abs(float(at) - float(aj)) <= ATOL


def test_per_row_dispatch_matches_vmap_over_rows():
    # 16 rows of one token under the default capacity factor 1.25: one
    # joint dispatch gives each expert 8 slots for 32 (token, k) pairs and
    # drops some; each row alone (capacity 1) drops none
    jcfg = dataclasses.replace(jconfigs.smoke(MOE), moe_capacity_factor=1.25)
    tcfg = dataclasses.replace(tconfigs.smoke(MOE), moe_capacity_factor=1.25)
    p = _moe_params(tcfg, 2)
    x = np.random.default_rng(3).standard_normal(
        (16, 1, tcfg.d_model)).astype(np.float32)
    joint = _port_dispatch(p, x, tcfg, 1.25)
    assert joint[3] == 8 and not joint[1].all()
    rows = _port_dispatch(p, x, tcfg, 1.25, per_row=True)
    assert rows[3] == 1 and rows[1].all()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for b in range(16):
        want = _jax_dispatch(jp, jnp.asarray(x[b:b + 1]), jcfg, 1.25)
        for i in range(3):
            np.testing.assert_array_equal(rows[i][b], want[i])
    yj, aj = jax.vmap(lambda xr: jl.moe_apply(jp, xr[None], jcfg))(
        jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    yt, at = tl.moe_apply(tp, torch.from_numpy(x), tcfg, per_row=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj)[:, 0], rtol=0,
                               atol=ATOL)
    assert abs(float(at) - float(jnp.mean(aj))) <= ATOL
    y_joint, _ = tl.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert not torch.allclose(y_joint, yt, rtol=0, atol=ATOL)


def test_capacity_rounds_half_to_even():
    cfg = dataclasses.replace(tconfigs.smoke(MOE), n_experts=4,
                              n_experts_per_tok=2)
    # N * K / E * cf / 8 = 20.5 -> 20 (half to even), 21.5 -> 22
    assert tl.moe_capacity(328, cfg, 1.0) == 160
    assert tl.moe_capacity(344, cfg, 1.0) == 176
    assert tl.moe_capacity(3, cfg, 8.0) == 3          # at most N
    assert tl.moe_capacity(40, cfg, 0.1) == 8         # at least 8


def _jax_init(arch):
    jm = jax_build(jconfigs.smoke(arch))
    return jm, jm.init(jax.random.PRNGKey(0))


def test_params_from_numpy_carries_the_moe_tree():
    jm, jp = _jax_init(MOE)
    tm = build_model(tconfigs.smoke(MOE))
    tp = params_from_numpy(
        tm.defs, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        "cpu")
    mlp = tp["moe"]["mlp"]
    assert set(tp) == {"embed", "moe", "ln_f"} and "dense" not in tp
    assert mlp["router"].dtype == torch.float32
    assert mlp["wi_gate"].dtype == torch.bfloat16
    assert tuple(mlp["router"].shape) == (2, 64, 4)
    assert tuple(mlp["wo"].shape) == (2, 4, 64, 64)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert str(a.dtype) == str(b.dtype).split(".")[1]
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


@pytest.fixture(scope="module", params=ARCHS)
def f32_pair(request):
    arch = request.param
    jm, jp = _jax_init(arch)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tm = build_model(tconfigs.smoke(arch))
    tp = params_from_numpy(tm.defs, jax.tree.map(np.asarray, jp), "cpu")
    return arch, jm, jp, tm, tree_map(lambda t: t.float(), tp)


def test_smoke_logits_match_repro_f32(f32_pair):
    arch, jm, jp, tm, tp = f32_pair
    prompt = np.random.default_rng(5).integers(0, 512, (1, P)).astype(
        np.int32)
    jcache = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init_cache(1, P + STEPS))
    tcache = tree_map(lambda t: t.float(), tm.init_cache(1, P + STEPS,
                                                         "cpu"))
    prefill = jax.jit(functools.partial(jm.prefill_fn, impl="xla"))
    decode = jax.jit(functools.partial(jm.decode_fn, impl="xla"))
    want, jcache = prefill(jp, jcache, {"tokens": jnp.asarray(prompt)})
    got, tcache = tm.prefill_fn(tp, tcache,
                                {"tokens": torch.from_numpy(prompt).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg=arch)
    for s in range(STEPS):
        tok = np.asarray(jnp.argmax(want, -1))[:, None]
        want, jcache = decode(jp, jcache, jnp.asarray(tok, jnp.int32),
                              jnp.int32(P + s))
        got, tcache = tm.decode_fn(tp, tcache, torch.tensor(tok).long(),
                                   P + s)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"{arch} step {s}")
    for a, b in zip(jax.tree.leaves(jcache), tree_leaves(tcache)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL, err_msg=arch)


def test_smoke_loss_matches_repro_f32(f32_pair):
    arch, jm, jp, tm, tp = f32_pair
    tokens = np.random.default_rng(6).integers(0, 512, (2, 12)).astype(
        np.int32)
    _, want = jm.loss_fn(jp, {"tokens": jnp.asarray(tokens)}, impl="xla")
    _, got = tm.loss_fn(tp, {"tokens": torch.from_numpy(tokens).long()})
    assert set(got) == set(want) == {"loss", "lm_loss", "aux_loss"}
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= ATOL, (arch, k)
    moe = tm.cfg.n_experts > 0
    assert (float(got["aux_loss"]) > 0) == moe
    assert (float(got["loss"]) != float(got["lm_loss"])) == moe


def test_dense_and_moe_stacks_keep_repro_trees():
    cfg = dataclasses.replace(jconfigs.smoke(MOE), n_layers=3,
                              n_dense_layers=1)
    tcfg = dataclasses.replace(tconfigs.smoke(MOE), n_layers=3,
                               n_dense_layers=1)
    jm, tm = jax_build(cfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = params_from_numpy(
        tm.defs, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        "cpu")
    assert set(tp) == {"embed", "dense", "moe", "ln_f"}
    assert tuple(tp["dense"]["mlp"]["wi_gate"].shape)[0] == 1
    assert tuple(tp["moe"]["mlp"]["wi_gate"].shape)[:2] == (2, 4)
    jdefs = jax.tree.leaves(jm.make_cache_defs(1, 9),
                            is_leaf=lambda d: hasattr(d, "logical"))
    tdefs = tree_leaves(tm.make_cache_defs(1, 9),
                        is_leaf=lambda d: hasattr(d, "logical"))
    assert [tuple(d.shape) for d in jdefs] == [tuple(d.shape) for d in tdefs]
    tokens = np.random.default_rng(7).integers(0, 512, (1, 10)).astype(
        np.int32)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    _, want = jm.loss_fn(jp32, {"tokens": jnp.asarray(tokens)}, impl="xla")
    _, got = tm.loss_fn(tree_map(lambda t: t.float(), tp),
                        {"tokens": torch.from_numpy(tokens).long()})
    for k in want:
        assert abs(float(got[k]) - float(want[k])) <= ATOL, k
