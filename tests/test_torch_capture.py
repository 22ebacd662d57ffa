"""The port's counterpart of ``jax.jit``: a decode position on the device,
the split-K decode's split rule for it, and the CUDA-graph entry points.

On the CPU:

  * decode with the position ``t`` a 0-d tensor is bit-equal to decode
    with ``t`` an int, for the smoke ``llama3.2-1b``, ``rwkv6-7b``,
    ``recurrentgemma-2b`` and ``granite-moe-3b-a800m`` (logits and caches,
    in bf16 and in f32); in f32
    the logits are also allclose to ``repro``'s ``jax.jit(decode_fn)`` with
    a traced ``jnp.int32(t)``, at ``test_torch_models.py``'s atol 1e-4
    (sums in another order).  The recurrent models' mixing leaves are
    filled as ``test_torch_recurrent_models.py`` fills them, so that the
    carried state matters; the Griffin prompt (24) is longer than its
    smoke window (16);
  * the plain chunked attention with a tensor position equals it with an
    int position over several chunks, windows and positions (there the
    tensor visits every chunk, the int skips the dead ones);
  * the capacity split rule (``kernel.capacity_splits``): the split-K
    decode's plain partials and merge with a tensor ``q_start`` equal
    ``attention_ref`` at every position from 0 to the capacity - 1, with
    and without a window (f32 atol 1e-5, sums in another order), and the
    rule covers the live tiles at every position and stays within one
    split of the host rule at the served shapes;
  * ``jit=True`` raises on a CPU program, ``execute(..., jit=)`` reaches
    ``PlanProgram.run``, and the capture helpers raise on the CPU.

On the card only (marked ``cuda``; skipped without one): a captured
execute is bit-equal to the eager slice and fused runs, and two runs with
other inputs each give their own outputs; the captured decode step gives
the eager step's logits bit for bit at every position, and the captured
batched step (4 rows, each at its own position) gives the eager batched
step's logits, next tokens and state bit for bit, for the four families;
and granite-20b's multi-query decode (48 heads over one KV head: the
split-K decode in three row blocks) captured, serial and at bucket 4,
bit-equal to the eager step, every attention call on the decode kernel.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import repro_torch as rt  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.graphs as tg  # noqa: E402
from repro_torch.core import executor as tx  # noqa: E402
from repro_torch.core.capture import CapturedCall  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    flash_attention,
    flash_decode_combine_torch,
    flash_decode_partials_torch,
)
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    CapturedBatchedDecodeStep,
    make_captured_decode_step,
)
from repro_torch.models.params import (  # noqa: E402
    params_from_numpy,
    tree_leaves,
    tree_map,
)
from repro_torch.models.zoo import build_model  # noqa: E402

ARCHS = ("llama3.2-1b", "rwkv6-7b", "recurrentgemma-2b",
         "granite-moe-3b-a800m")
PROMPT = {"llama3.2-1b": 8, "rwkv6-7b": 8, "recurrentgemma-2b": 24,
          "granite-moe-3b-a800m": 8}
RECURRENT = ("rwkv6-7b", "recurrentgemma-2b")
STEPS, BATCH = 4, 2
ATOL32 = 1e-4          # f32 logits against repro's (test_torch_models.py)
SPLIT_ATOL = 1e-5      # the split decode against attention_ref, f32


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both packages' smoke model of one family, the same parameters (the
    recurrent mixing leaves filled), a seeded prompt and repro's f32
    greedy tokens and logits from a jitted decode with a traced
    position.  JAX is imported here, so that the card's tests of this
    file run where JAX is not installed."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    import repro.configs as jconfigs
    from repro.models.zoo import build_model as jax_build
    from test_torch_recurrent_models import live_leaves

    arch = request.param
    jm = jax_build(jconfigs.smoke(arch))
    tm = build_model(tconfigs.smoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    if arch in RECURRENT:
        jp = live_leaves(arch, jp)
    tp = params_from_numpy(
        tm.defs, jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        "cpu")
    P = PROMPT[arch]
    prompt = np.random.default_rng(7).integers(
        0, jm.cfg.vocab_size, (BATCH, P)).astype(np.int32)
    f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32), t)
    prefill = jax.jit(functools.partial(jm.prefill_fn, impl="xla"))
    decode = jax.jit(functools.partial(jm.decode_fn, impl="xla"))
    logits, cache = prefill(f32(jp), f32(jm.init_cache(BATCH, P + STEPS)),
                            {"tokens": jnp.asarray(prompt)})
    want, toks = [np.asarray(logits)], []
    for s in range(STEPS):
        tok = np.array(jnp.argmax(logits, -1), np.int32)[:, None]
        toks.append(tok)
        logits, cache = decode(f32(jp), cache, jnp.asarray(tok),
                               jnp.int32(P + s))
        want.append(np.asarray(logits))
    return arch, tm, tp, prompt, toks, want


def _port(tm, params, prompt, toks, *, tensor_t, dtype):
    """Prefill + STEPS decode steps fed ``toks``; the position an int or a
    0-d tensor.  Returns the logits of every step and the final cache."""
    P = prompt.shape[1]
    cache = tm.init_cache(BATCH, P + STEPS, "cpu")
    if dtype == "f32":
        params = tree_map(lambda t: t.float(), params)
        cache = tree_map(lambda t: t.float(), cache)
    logits, cache = tm.prefill_fn(
        params, cache, {"tokens": torch.from_numpy(prompt).long()})
    out = [logits]
    for s, tok in enumerate(toks):
        t = torch.tensor(P + s) if tensor_t else P + s
        logits, cache = tm.decode_fn(params, cache,
                                     torch.from_numpy(tok).long(), t)
        out.append(logits)
    return out, tree_leaves(cache)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_tensor_position_bit_equal_to_int(pair, dtype):
    arch, tm, tp, prompt, toks, want = pair
    by_int, cache_int = _port(tm, tp, prompt, toks, tensor_t=False,
                              dtype=dtype)
    by_tensor, cache_tensor = _port(tm, tp, prompt, toks, tensor_t=True,
                                    dtype=dtype)
    for s, (a, b) in enumerate(zip(by_int, by_tensor)):
        assert torch.equal(a, b), f"{arch} {dtype} step {s}"
    for a, b in zip(cache_int, cache_tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), arch
    if dtype == "f32":
        for s, (g, w) in enumerate(zip(by_tensor, want)):
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL32,
                                       err_msg=f"{arch} step {s}")


@pytest.mark.parametrize("window", [None, 5, 40])
def test_flash_torch_tensor_position_equals_int(window):
    # 4 chunks of 16 keys over a cache of 61 (the last chunk ragged): the
    # int position skips the chunks it knows dead, the tensor visits all
    rng = np.random.default_rng(3)
    B, Skv, H, KV, D = 1, 61, 4, 2, 16
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, KV, D))
                             .astype(np.float32)) for _ in range(2))
    for t in (0, 1, 15, 16, 33, 47, 60):
        for Sq in (1, 2):
            if t + Sq > Skv:
                continue
            q = torch.from_numpy(rng.standard_normal((B, Sq, H, D))
                                 .astype(np.float32))
            kw = dict(causal=True, window=window, impl="torch", kv_chunk=16)
            a = flash_attention(q, k, v, q_start=t, kv_len=t + Sq, **kw)
            tt = torch.tensor(t)
            b = flash_attention(q, k, v, q_start=tt, kv_len=tt + Sq, **kw)
            assert torch.equal(a, b), (window, t, Sq)
            ref = attention_ref(q, k, v, causal=True, window=window,
                                q_start=tt, kv_len=tt + Sq)
            want = attention_ref(q, k, v, causal=True, window=window,
                                 q_start=t, kv_len=t + Sq)
            assert torch.equal(ref, want), (window, t, Sq)


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("Sq", [1, 2])
def test_capacity_split_rule_every_position(window, Sq):
    rng = np.random.default_rng(11)
    B, Skv, H, KV, D = 1, 100, 8, 2, 16
    k, v = (torch.from_numpy(rng.standard_normal((B, Skv, KV, D))
                             .astype(np.float32)) for _ in range(2))
    S, tpc = fk.capacity_splits(B, KV, Sq, H, D, Skv=Skv, causal=True,
                                window=window)
    for t in range(Skv - Sq + 1):
        q = torch.from_numpy(rng.standard_normal((B, Sq, H, D))
                             .astype(np.float32))
        n = fk.live_tiles(Sq, causal=True, window=window, q_start=t,
                          kv_len=t + Sq)[1]
        assert 0 < n <= S * tpc, (t, n, S, tpc)
        m, l, acc = flash_decode_partials_torch(
            q, k, v, causal=True, window=window, q_start=torch.tensor(t))
        assert m.shape[2] == S
        got = flash_decode_combine_torch(m, l, acc)
        want = attention_ref(q, k, v, causal=True, window=window,
                             q_start=t, kv_len=t + Sq)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=SPLIT_ATOL, err_msg=f"t {t}")


def test_capacity_split_rule_at_served_shapes():
    # llama3.2-1b: 1056 keys over B * KV = 8 -> 17 splits of 2 tiles, as
    # the host rule gives at every served position (kv_len 1025..1056)
    assert fk.capacity_tiles(1, 1056, causal=True, window=None) == 33
    assert fk.capacity_splits(1, 8, 1, 32, 64, Skv=1056, causal=True,
                              window=None) == (17, 2)
    # recurrentgemma-2b: 2592 keys, window 2048 -> 66 tiles at most, the
    # merge's cap keeps 33 splits of 2 (the host rule: 32 or 33)
    assert fk.capacity_tiles(1, 2592, causal=True, window=2048) == 66
    assert fk.capacity_splits(1, 1, 1, 10, 256, Skv=2592, causal=True,
                              window=2048) == (33, 2)
    for (KV, H, Dv, Skv, w, lo) in ((8, 32, 64, 1056, None, 1024),
                                    (1, 10, 256, 2592, 2048, 2560)):
        cap = fk.capacity_splits(1, KV, 1, H, Dv, Skv=Skv, causal=True,
                                 window=w)[0]
        for t in range(lo, Skv):
            host = fk.decode_splits(1, KV, 1, H, Dv, causal=True, window=w,
                                    q_start=t, kv_len=t + 1)[0]
            assert 0 <= cap - host <= 1, (Skv, t, cap, host)
    # non-causal or windowless: the whole cache
    assert fk.capacity_tiles(1, 100, causal=False, window=40) == 4


def test_device_position_route_and_dtype_checked_on_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_decode_cuda(*(torch.zeros(1, 1, 4, 16) for _ in range(3)),
                             causal=True, window=None,
                             q_start=torch.tensor(0))


def _darts_cell():
    p = rt.plan(tg.darts_normal_cell(), rt.PlanConfig())
    return p, tx.PlanProgram(p.graph, p.order, p.arena, device="cpu")


def test_jit_raises_on_cpu():
    p, prog = _darts_cell()
    with pytest.raises(tx.ExecutorError, match="CUDA graph"):
        prog.run(jit=True)
    with pytest.raises(tx.ExecutorError, match="CUDA graph"):
        rt.execute(p.graph, None, p.arena, order=p.order, device="cpu",
                   jit=True)
    with pytest.raises(tx.ExecutorError, match="CUDA graph"):
        rt.execute_plan(p.graph, p.order, p.arena, device="cpu", jit=True,
                        fuse=True)
    # the eager run is untouched by the option
    assert prog.run(jit=False).realized_matches_plan


def test_capture_helpers_raise_on_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        CapturedCall(lambda: torch.zeros(1), "cpu")
    tm = build_model(tconfigs.smoke("llama3.2-1b"))
    with pytest.raises(ValueError, match="CUDA"):
        make_captured_decode_step(tm, None, smax=8, device="cpu")


@pytest.mark.parametrize("jit", [False, True])
def test_execute_forwards_jit_to_program_run(monkeypatch, jit):
    seen = []

    def run(self, inputs=None, *, arena=None, jit=False, strict=True):
        seen.append((self.fuse, jit, strict))
        return "ran"

    monkeypatch.setattr(tx.PlanProgram, "run", run)
    p, _ = _darts_cell()
    assert rt.execute(p.graph, None, p.arena, order=p.order, device="cpu",
                      jit=jit, fuse=True) == "ran"
    assert rt.execute(tg.darts_normal_cell(), device="cpu", jit=jit) == "ran"
    assert seen == [(True, jit, True), (False, jit, True)]


def test_unpack_buffer_into_out():
    p, _ = _darts_cell()
    u = p.order[3]
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    arena = rt.pack_buffers(p.arena, {u: x}, device="cpu")
    out = torch.full((3, 4), -1, dtype=torch.int32)
    back = rt.unpack_buffer(arena, p.arena, u, (3, 4), torch.int32, out=out)
    assert back is out and torch.equal(out, x)
    with pytest.raises(tx.ExecutorError, match="contiguous"):
        rt.unpack_buffer(arena, p.arena, u, (3, 4), torch.int32,
                         out=torch.zeros(4, 3, dtype=torch.int32).t())


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(g, seed):
    rng = np.random.default_rng(seed)
    return {g.nodes[u].name: rng.standard_normal(g.sizes[u] // 4)
            .astype(np.float32) for u in tx.input_nodes(g)}


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_captured_execute_bit_equal_on_card(card, fuse):
    p = rt.plan(tg.FULL_NETWORKS["darts_net_x6"](), rt.PlanConfig())
    a, b = _inputs(p.graph, 0), _inputs(p.graph, 1)
    run = functools.partial(rt.execute, p.graph, plan=p.arena,
                            order=p.order, fuse=fuse, device=card)
    eager_a, eager_b = run(a).outputs, run(b).outputs
    first = run(a, jit=True)             # the warm-up, then the capture
    again = run(a, jit=True).outputs     # a replay
    other = run(b, jit=True).outputs     # a replay with other inputs
    assert first.realized_matches_plan
    for k in eager_a:
        assert torch.equal(first.outputs[k], eager_a[k])
        assert torch.equal(again[k], eager_a[k])
        assert torch.equal(other[k], eager_b[k])
        assert not torch.equal(eager_a[k], eager_b[k])


@pytest.mark.cuda
def test_captured_decode_step_bit_equal_on_card(card):
    tm = build_model(tconfigs.smoke("llama3.2-1b"))
    params = tm.init(torch.Generator(device=card).manual_seed(0), card)
    P, smax = 8, 16
    prompt = torch.arange(P, device=card)[None] % tm.cfg.vocab_size
    cache = tm.init_cache(1, smax, card)
    logits, cache = tm.prefill_fn(params, cache, {"tokens": prompt})
    step = make_captured_decode_step(tm, params, smax=smax, device=card)
    for dst, src in zip(tree_leaves(step.cache), tree_leaves(cache)):
        dst.copy_(src)
    tok = int(logits.argmax(-1)[0])
    for t in range(P, smax):
        want, cache = tm.decode_fn(params, cache,
                                   torch.tensor([[tok]], device=card), t)
        got = step(tok, t)
        assert torch.equal(got, want), t
        tok = int(want.argmax(-1)[0])
    assert step.call.replays == smax - P - 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_captured_batched_step_bit_equal_on_card(card, arch):
    cfg = tconfigs.smoke(arch)
    if cfg.head_dim not in (16, 64, 128, 256):
        # Griffin's smoke head dim (32) is not one the flash kernels take
        cfg = dataclasses.replace(cfg, head_dim=64)
    tm = build_model(cfg)
    params = tm.init(torch.Generator(device=card).manual_seed(0), card)
    smax, B = 40, 4
    step = CapturedBatchedDecodeStep(tm, params, bucket=B, smax=smax,
                                     device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    for leaf in tree_leaves(step.cache):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=card))
    cache = tree_map(lambda t: t.clone(), step.cache)
    lens = [5, 9, 20, 31]
    toks = [1, 2, 3, 4]
    for s in range(4):
        ts = [n + s for n in lens]
        want, cache = tm.decode_fn(
            params, cache, torch.tensor(toks, device=card)[:, None],
            torch.tensor(ts, device=card))
        logits, nxt = step(toks, ts)
        assert torch.equal(logits, want), s
        assert nxt.tolist() == want.argmax(-1).tolist()
        toks = nxt.tolist()
    for a, b in zip(tree_leaves(step.cache), tree_leaves(cache)):
        assert torch.equal(a, b)
    assert step.call.replays == 3


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [None, 4])
def test_captured_row_blocked_decode_bit_equal_on_card(card, bucket):
    """granite-20b's multi-query decode (48 heads over one KV head, three
    row blocks of the split-K decode) captured, serial (``bucket`` None)
    and batched, bit-equal to the eager step; the decode kernel takes
    every step."""
    from repro_torch.kernels.flash_attention import kernel as fk

    cfg = dataclasses.replace(tconfigs.smoke("granite-20b"), n_heads=48,
                              head_dim=64)
    tm = build_model(cfg)
    params = tm.init(torch.Generator(device=card).manual_seed(0), card)
    smax = 40
    B = bucket or 1
    if bucket:
        step = CapturedBatchedDecodeStep(tm, params, bucket=B, smax=smax,
                                         device=card)
    else:
        step = make_captured_decode_step(tm, params, smax=smax, device=card)
    gen = torch.Generator(device=card).manual_seed(1)
    for leaf in tree_leaves(step.cache):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=card))
    cache = tree_map(lambda t: t.clone(), step.cache)
    lens = [5, 9, 20, 31][:B]
    toks = [1, 2, 3, 4][:B]
    fk.reset_launches()
    for s in range(4):
        ts = [n + s for n in lens]
        t = torch.tensor(ts, device=card) if bucket else ts[0]
        want, cache = tm.decode_fn(
            params, cache, torch.tensor(toks, device=card)[:, None], t)
        got = step(toks, ts) if bucket else step(toks[0], ts[0])
        logits = got[0] if bucket else got
        assert torch.equal(logits, want), s
        toks = want.argmax(-1).tolist()
    for a, b in zip(tree_leaves(step.cache), tree_leaves(cache)):
        assert torch.equal(a, b)
    assert fk.LAUNCHES["flash_decode"] == 2 * 4 * cfg.n_layers
    assert fk.LAUNCHES["flash_prefill"] == fk.LAUNCHES["flash_attention"] == 0
