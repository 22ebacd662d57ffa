"""The port's decode-arena server against ``repro``'s, on the CPU.

  * ``decode_state_graph`` / ``plan_decode_arena`` give integer-equal plans
    (arena, resident extent, transients, order, every ``offset_of``) for
    the smoke config at a few ``smax`` and for the full ``llama3.2-1b``
    config at ``smax`` 1056 (planning only, no parameters);
  * the packed decode state is byte-equal to ``repro``'s and round-trips
    bit-equal;
  * ``run_server(device="cpu")`` serves the same requests with the same
    (JAX-initialized, bf16) parameters as ``repro``'s ``run_server``:
    equal tokens per request and equal integer metrics, under a budget
    that queues;
  * a mid-run budget shrink preempts, spills and re-admits; the surviving
    tokens are bit-equal to the fault-free run of the port, and the ladder
    takes the same decisions as ``repro``'s;
  * ``step_mode="vmap"`` on a serial-overlap pool and the card's default
    without CUDA raise;
  * this slice's decoders: decode plans integer-equal for the full
    ``granite-moe-3b-a800m``, ``gemma-7b``, ``starcoder2-7b``,
    ``granite-20b`` and ``chameleon-34b`` at ``smax`` 1056 (both stacks'
    cache leaves, ``{"dense", "moe"}`` in ``repro``'s leaf order, where a
    config has both); on ``granite-moe-smoke`` and ``granite-20b-smoke``
    the packed decode state byte-equal to ``repro``'s, and the server's
    tokens per request and integer metrics equal to ``repro``'s;
  * the recurrent families: decode plans integer-equal for the full
    ``rwkv6-7b`` at ``smax`` 1056 and ``recurrentgemma-2b`` at 2592
    (mixed bf16/f32 leaves, Griffin's list-valued ``tail``); on their
    smoke configs, with the live recurrent leaves of
    ``test_torch_recurrent_models.live_leaves``, the port's server gives
    ``repro``'s integer metrics, its tokens are bit-equal to the port's
    own arena-free loop (the recurrent state survives the arena), and
    they equal ``repro``'s served tokens up to the first step at which the
    reference's own top-1 margin is within the bf16 noise (``TIE``).
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
from repro.models.zoo import build_model as jax_build  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core import plan_shared_arena  # noqa: E402
from repro_torch.core.executor import ExecutorError  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    is_def,
    params_from_numpy,
    tree_leaves,
    tree_map,
)
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    ChaosController,
    FaultPlan,
    FaultSpec,
)
from test_torch_recurrent_models import _to_port, live_leaves  # noqa: E402

ARCH = "llama3.2-1b"
METRICS = ("n_requests", "n_served", "n_rejected", "n_tokens",
           "max_concurrent", "peak_reserved_bytes", "budget_bytes",
           "warm_hits", "plan_hits", "steps", "arena_bytes",
           "persistent_bytes", "transient_bytes", "n_preempted")


@pytest.fixture(scope="module")
def smoke():
    jm = jax_build(jconfigs.smoke(ARCH))
    tm = build_model(tconfigs.smoke(ARCH))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(
        tm.defs, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        "cpu")
    return jm, tm, jp, tp


def _assert_plans_equal(jp, tp):
    for k in ("arena_bytes", "naive_bytes", "peak_bytes", "policy",
              "persistent_bytes", "resident_extent", "transient_bytes",
              "n_buffers", "n_cache", "order"):
        assert jp[k] == tp[k], k
    n = jp["n_buffers"]
    assert [jp["plan"].offset_of(i) for i in range(n)] == \
        [tp["plan"].offset_of(i) for i in range(n)]
    assert list(jp["graph"].sizes) == list(tp["graph"].sizes)


@pytest.mark.parametrize("smax", [12, 40, 97])
def test_decode_plans_equal_smoke(smoke, smax):
    jm, tm, _, _ = smoke
    _assert_plans_equal(jserve.plan_decode_arena(jm, 1, smax),
                        tserve.plan_decode_arena(tm, 1, smax))


def test_decode_plan_equal_full_llama_at_1056():
    jp = jserve.plan_decode_arena(jax_build(jconfigs.get(ARCH)), 1, 1056)
    tp = tserve.plan_decode_arena(build_model(tconfigs.get(ARCH)), 1, 1056)
    _assert_plans_equal(jp, tp)
    assert (tp["arena_bytes"], tp["resident_extent"], tp["transient_bytes"],
            tp["n_buffers"]) == (35_124_228, 34_603_012, 521_216, 53)


def test_packed_state_equals_repro_and_round_trips(smoke):
    jm, tm, _, _ = smoke
    smax = 12
    rng = np.random.default_rng(0)
    shape = (2, 1, smax, 2, 16)
    ks, vs = (rng.standard_normal(shape).astype(np.float32)
              for _ in range(2))
    jplan = jserve.plan_decode_arena(jm, 1, smax)
    tplan = tserve.plan_decode_arena(tm, 1, smax)
    jcache = {"dense": {"k": jnp.asarray(ks, jnp.bfloat16),
                        "v": jnp.asarray(vs, jnp.bfloat16)}}
    tcache = {"dense": {"k": torch.from_numpy(ks).bfloat16(),
                        "v": torch.from_numpy(vs).bfloat16()}}
    want = np.asarray(jserve.pack_decode_state(jplan, jcache))
    arena = tserve.pack_decode_state(tplan, tcache)
    assert arena.dtype == torch.uint8
    np.testing.assert_array_equal(arena.numpy(), want)
    back = tserve.unpack_decode_state(tplan, arena, tm.make_cache_defs(1,
                                                                       smax))
    for leaf in ("k", "v"):
        assert torch.equal(back["dense"][leaf], tcache["dense"][leaf])
    arena2, rebuilt = tserve.realize_decode_state(tplan, tcache)
    assert torch.equal(arena2, arena)
    assert torch.equal(rebuilt["dense"]["v"], tcache["dense"]["v"])
    # a leased buffer is written in place
    buf = torch.zeros(tplan["resident_extent"], dtype=torch.uint8)
    assert tserve.pack_decode_state(tplan, tcache, arena=buf) is buf
    assert torch.equal(buf, arena)


@pytest.mark.parametrize("pooled", [True, False])
def test_server_matches_repro(smoke, pooled):
    jm, tm, jp, tp = smoke
    P, GEN = 8, 4
    smax = P + GEN
    budget = 12_000          # three of the six requests fit at a time
    kw = dict(smax=smax, budget_bytes=budget, pooled=pooled, warm=2)
    jreqs = jserve.synth_requests(6, P, GEN, 512, seed=1)
    treqs = tserve.synth_requests(6, P, GEN, 512, seed=1)
    jm_ = jserve.run_server(jm, jp, jreqs, **kw)
    tm_ = tserve.run_server(tm, tp, treqs, device="cpu", **kw)
    assert tm_["max_concurrent"] < 6        # the budget queued
    for k in METRICS:
        assert tm_[k] == jm_[k], k
    for a, b in zip(jreqs, treqs):
        assert (a.rid, a.rejected) == (b.rid, b.rejected)
        assert list(a.tokens) == list(b.tokens), a.rid


def _serve(srv, model, params, chaos=None, **kw):
    P, GEN = 4, 8
    smax = P + GEN
    plan = srv.plan_decode_arena(model, 1, smax)
    budget = plan_shared_arena([plan["plan"]] * 3).arena_bytes
    reqs = srv.synth_requests(4, P, GEN, 512, seed=3, latency_frac=0.5,
                              priorities=(0, 1))
    m = srv.run_server(model, params, reqs, smax=smax, budget_bytes=budget,
                       warm=1, chaos=chaos, **kw)
    return reqs, m


def _shrink():
    return ChaosController(FaultPlan([FaultSpec("budget_shrink", 2, 0.5)]))


def test_budget_shrink_preempts_readmits_and_keeps_tokens(smoke):
    jm, tm, jp, tp = smoke
    base_reqs, _ = _serve(tserve, tm, tp, device="cpu")
    reqs, m = _serve(tserve, tm, tp, chaos=_shrink(), device="cpu")
    assert m["budget_shrinks"] == 1 and m["n_preempted"] >= 1
    assert m["spill_bytes"] > 0 and m["n_readmitted"] >= 1
    assert m["max_over_budget_bytes"] <= 0
    assert m["n_served"] + m["n_rejected"] == len(reqs)
    base = {r.rid: list(r.tokens) for r in base_reqs if not r.rejected}
    served = [r for r in reqs if not r.rejected]
    assert any(r.preemptions for r in served)
    for r in served:
        assert list(r.tokens) == base[r.rid]
    # the ladder took the same decisions as repro's
    jreqs, jm_ = _serve(jserve, jm, jp, chaos=_shrink())
    for k in METRICS + ("n_readmitted", "spill_bytes", "ladder",
                        "reject_codes", "min_budget_bytes"):
        assert m[k] == jm_[k], k
    for a, b in zip(jreqs, reqs):
        assert (a.rejected, a.preemptions, list(a.tokens)) == \
            (b.rejected, b.preemptions, list(b.tokens))


def test_vmap_and_missing_card_raise(smoke):
    _, tm, _, tp = smoke
    reqs = tserve.synth_requests(1, 4, 2, 512)
    # vmap serves (tests/test_torch_serve_vmap.py), but not on a pool that
    # admits with serial-overlap accounting
    with pytest.raises(ValueError, match="overlap='none'"):
        tserve.DecodeServer(tm, tp, tserve.make_pool(10**6, device="cpu"),
                            smax=6, step_mode="vmap", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ExecutorError, match="CUDA"):
            tserve.run_server(tm, tp, reqs, smax=6, budget_bytes=10**6)
        with pytest.raises(ExecutorError, match="CUDA"):
            tserve.make_pool(10**6)


# ------------------------------------------------------------ recurrent

# the full configs' decode plans: arena, resident extent, transients,
# buffers (ISSUE-independent: planned by repro in the same test)
RECURRENT_PLANS = {
    "rwkv6-7b": (1056, (34_357_252, 34_078_724, 278_528, 102)),
    "recurrentgemma-2b": (2592, (22_728_708, 21_694_468, 1_034_240, 89)),
}
# a little over twice the bf16 logit gap between the packages on the
# smoke configs (7.4e-2 and 1.8e-2, tools/recurrent_parity.py): a
# reference top-1 margin within it is a tie bf16 rounding may break
# either way
TIE = {"rwkv6-7b": 0.2, "recurrentgemma-2b": 4e-2}
# (prompt, generated) per request; Griffin's prompt is longer than the
# smoke window of 16; RWKV-6 decodes longer, its margins being thinner
RECURRENT_LENS = {"rwkv6-7b": (8, 8), "recurrentgemma-2b": (20, 4)}


@pytest.mark.parametrize("arch", sorted(RECURRENT_PLANS))
def test_decode_plan_equal_full_recurrent(arch):
    smax, ints = RECURRENT_PLANS[arch]
    jp = jserve.plan_decode_arena(jax_build(jconfigs.get(arch)), 1, smax)
    tp = tserve.plan_decode_arena(build_model(tconfigs.get(arch)), 1, smax)
    _assert_plans_equal(jp, tp)
    assert (tp["arena_bytes"], tp["resident_extent"], tp["transient_bytes"],
            tp["n_buffers"]) == ints


def _reference_margins(jm, jp, prompt, tokens, prefill, decode):
    """Top-1 minus top-2 logit of ``repro``'s arena-free prefill + decode
    (jitted ``prefill``/``decode`` of ``jm``) at each generated step, fed
    ``tokens``."""
    P = len(prompt)
    cache = jm.init_cache(1, P + len(tokens))
    logits, cache = prefill(jp, cache,
                            {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
    out = []
    for s, tok in enumerate(tokens):
        top2 = np.sort(np.asarray(logits, np.float32)[0])[-2:]
        out.append(float(top2[1] - top2[0]))
        logits, cache = decode(jp, cache, jnp.full((1, 1), tok, jnp.int32),
                               jnp.int32(P + s))
    return out


def _port_direct(tm, tp, prompt, gen):
    """The port's arena-free greedy loop (the cache kept as tensors)."""
    P = len(prompt)
    cache = tm.init_cache(1, P + gen, "cpu")
    logits, cache = tm.prefill_fn(
        tp, cache, {"tokens": torch.as_tensor(prompt).long()[None]})
    toks = [int(logits.argmax(-1))]
    for s in range(gen - 1):
        logits, cache = tm.decode_fn(tp, cache,
                                     torch.tensor([[toks[-1]]]), P + s)
        toks.append(int(logits.argmax(-1)))
    return toks


@pytest.mark.parametrize("arch", sorted(RECURRENT_PLANS))
def test_recurrent_server_matches_repro(arch):
    P, GEN = RECURRENT_LENS[arch]
    smax = P + GEN
    jm = jax_build(jconfigs.smoke(arch))
    tm = build_model(tconfigs.smoke(arch))
    jp = live_leaves(arch, jm.init(jax.random.PRNGKey(0)))
    tp = _to_port(tm, jp)
    plan = tserve.plan_decode_arena(tm, 1, smax)
    budget = plan_shared_arena([plan["plan"]] * 3).arena_bytes
    kw = dict(smax=smax, budget_bytes=budget, warm=2)
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
        assert list(b.tokens) == _port_direct(tm, tp, b.prompt, GEN), b.rid
        # equal wherever the reference is clear, until a tie went the
        # other way (the two requests then decode different inputs)
        margins = _reference_margins(jm, jp, a.prompt, list(a.tokens),
                                     *steps)
        for s, m in enumerate(margins):
            if m > TIE[arch]:
                assert b.tokens[s] == a.tokens[s], (a.rid, s, m)
                compared += 1
            if b.tokens[s] != a.tokens[s]:
                break
    assert compared >= len(jreqs) * GEN // 3, compared


# ------------------------------------------------------------ this slice's
# decoders: the MoE decoder and the four other dense configs

# a reference top-1 margin within llama3.2-1b's bf16 logit tolerance is a
# tie that rounding may break either way (the MoE's router can flip a
# near-tie expert on the same noise)
DECODER_TIE = 5e-2
# arena, resident extent, transients, buffers of each full config at smax
# 1056 (1024 prompt + 32 generated), as chip_smoke.py's SERVES holds them
DECODER_PLANS = {
    "granite-moe-3b-a800m": (69_408_784, 69_206_020, 202_764, 101),
    "gemma-7b": (485_478_404, 484_442_116, 1_036_288, 89),
    "starcoder2-7b": (69_421_060, 69_206_020, 215_040, 101),
    "granite-20b": (28_336_132, 28_114_948, 221_184, 161),
    "chameleon-34b": (207_912_964, 207_618_052, 294_912, 149),
}


@pytest.mark.parametrize("arch", sorted(DECODER_PLANS))
def test_decode_plan_equal_full_decoders(arch):
    jp = jserve.plan_decode_arena(jax_build(jconfigs.get(arch)), 1, 1056)
    tp = tserve.plan_decode_arena(build_model(tconfigs.get(arch)), 1, 1056)
    _assert_plans_equal(jp, tp)
    assert (tp["arena_bytes"], tp["resident_extent"], tp["transient_bytes"],
            tp["n_buffers"]) == DECODER_PLANS[arch]


def test_decode_plan_equal_dense_and_moe_stacks():
    import dataclasses

    arch = "granite-moe-3b-a800m"
    jcfg = dataclasses.replace(jconfigs.smoke(arch), n_layers=3,
                               n_dense_layers=1)
    tcfg = dataclasses.replace(tconfigs.smoke(arch), n_layers=3,
                               n_dense_layers=1)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jp = jserve.plan_decode_arena(jm, 1, 20)
    tp = tserve.plan_decode_arena(tm, 1, 20)
    _assert_plans_equal(jp, tp)
    assert tp["n_cache"] == 4          # dense k, v, then moe k, v


@pytest.fixture(scope="module", params=["granite-moe-3b-a800m",
                                        "granite-20b"])
def decoder(request):
    arch = request.param
    jm = jax_build(jconfigs.smoke(arch))
    tm = build_model(tconfigs.smoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(
        tm.defs, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        "cpu")
    return arch, jm, tm, jp, tp


def test_decoder_packed_state_equals_repro(decoder):
    arch, jm, tm, _, _ = decoder
    smax = 12
    rng = np.random.default_rng(4)
    jplan = jserve.plan_decode_arena(jm, 1, smax)
    tplan = tserve.plan_decode_arena(tm, 1, smax)
    _assert_plans_equal(jplan, tplan)
    defs = tm.make_cache_defs(1, smax)
    vals = tree_map(lambda d: rng.standard_normal(d.shape).astype(np.float32),
                    defs, is_leaf=is_def)
    jcache = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), vals)
    tcache = tree_map(lambda a: torch.from_numpy(a).bfloat16(), vals)
    want = np.asarray(jserve.pack_decode_state(jplan, jcache))
    arena = tserve.pack_decode_state(tplan, tcache)
    np.testing.assert_array_equal(arena.numpy(), want)
    back = tserve.unpack_decode_state(tplan, arena, defs)
    for a, b in zip(tree_leaves(back), tree_leaves(tcache)):
        assert torch.equal(a, b)


def test_decoder_server_matches_repro(decoder):
    arch, jm, tm, jp, tp = decoder
    P, GEN = 8, 4
    smax = P + GEN
    plan = tserve.plan_decode_arena(tm, 1, smax)
    budget = plan_shared_arena([plan["plan"]] * 3).arena_bytes
    kw = dict(smax=smax, budget_bytes=budget, warm=2)
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
        assert list(b.tokens) == _port_direct(tm, tp, b.prompt, GEN), b.rid
        margins = _reference_margins(jm, jp, a.prompt, list(a.tokens),
                                     *steps)
        for s, m in enumerate(margins):
            if m > DECODER_TIE:
                assert b.tokens[s] == a.tokens[s], (a.rid, s, m)
                compared += 1
            if b.tokens[s] != a.tokens[s]:
                break
    assert compared >= len(jreqs) * GEN // 2, compared
