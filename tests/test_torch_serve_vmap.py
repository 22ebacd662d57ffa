"""The port's batched decode (``step_mode="vmap"``) against its serial
decode and against ``repro``'s batched server, on the CPU.

  * the plain attention at a ``(B,)`` position (a position per batch row):
    ``flash_attention(impl="torch")``, ``attention_ref`` and the split-K
    decode's plain partials + merge each give, row by row, what
    ``attention_ref`` gives for that row alone at its int position and
    what the plain attention gives for the row alone at its 0-d tensor
    position, with and without a window (f32, atol 1e-5: sums in another
    order);
  * ``decode_fn`` at a ``(B,)`` position (rows prefilled to different
    lengths, Griffin's past its window) gives each row's logits and state
    of the same row decoded alone at its scalar position, in f32 within
    1e-5, for the three families;
  * the server: batch buckets round up to powers of two; 3 requests pad
    to bucket 4 and charge the padding row to the pool
    (``peak_reserved_bytes >= 4 * arena_bytes``); under a budget of 3
    naive arenas the step runs at the exact batch, never over budget;
    ``step_mode="vmap"`` refuses a serial-overlap pool; rung 2 of the
    degradation ladder releases the server's padding scratch (the twin of
    ``tests/test_chaos.py::test_shrink_with_scratch_reserved_sheds_scratch``);
    vmap and serial serve the same tokens in f32; a queue that drains
    through buckets 4, 2 and 1 keeps one bucket's step at a time (the
    previous one freed) and serves the serial tokens;
  * against ``repro``'s ``DecodeServer(step_mode="vmap")`` from the same
    parameters, with a queue, with a padded bucket and at the exact batch:
    the pool's integers exactly (peak reserved bytes, the padding row's
    scratch included), and the tokens equal up to a first divergence,
    which only a step whose ``repro`` top-1 margin is within the bf16 noise
    may cause (``TIE``; llama3.2-1b at its bf16 logit tolerance 5e-2).

Each server and decode test runs for the four families: the dense
``llama3.2-1b``, ``rwkv6-7b``, ``recurrentgemma-2b`` and the MoE
``granite-moe-3b-a800m``, whose batched step dispatches each row on its
own (``moe_apply(per_row=True)``), as ``repro``'s ``jax.vmap`` of the
batch-1 step does: rows, padding rows included, never compete for an
expert's slots.

On the card, ``tests/test_torch_capture.py`` holds the captured batched
step bit-equal to the eager batched step.
"""

import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.zoo import build_model as jax_build  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core import plan_shared_arena  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_ref,
    flash_attention,
    flash_decode_combine_torch,
    flash_decode_partials_torch,
)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import CapturedBatchedDecodeStep  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    is_def,
    tree_leaves,
    tree_map,
)
from repro_torch.models.zoo import build_model  # noqa: E402
from test_torch_recurrent_models import _to_port, live_leaves  # noqa: E402
from test_torch_serve import (  # noqa: E402
    METRICS,
    RECURRENT_LENS,
    TIE,
    _reference_margins,
)

MOE = "granite-moe-3b-a800m"
ARCHS = ("llama3.2-1b", "rwkv6-7b", "recurrentgemma-2b", MOE)
# (prompt, generated) per request; Griffin's prompt is longer than the
# smoke window of 16
LENS = {"llama3.2-1b": (4, 3), MOE: (4, 3), **RECURRENT_LENS}
# a reference top-1 margin within the model's bf16 logit tolerance is a
# tie rounding may break either way (llama3.2-1b: PERF.md's 5e-2; the
# MoE decoder is held to the same)
TIES = {"llama3.2-1b": 5e-2, MOE: 5e-2, **TIE}
ATOL = 1e-5            # f32: sums in another order


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both packages' smoke model of one family with the same parameters
    (the recurrent mixing leaves filled, so the carried state matters):
    ``repro``'s tree, the port's in bf16 and the port's in f32."""
    arch = request.param
    jm = jax_build(jconfigs.smoke(arch))
    tm = build_model(tconfigs.smoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    if arch in TIE:                    # the recurrent families
        jp = live_leaves(arch, jp)
    tp = _to_port(tm, jp)
    return arch, jm, tm, jp, tp, tree_map(lambda t: t.float(), tp)


# ------------------------------------------------ attention at (B,) rows

def _qkv(B, H, KV, D, Skv, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, 1, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    return q, k, v


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("H,KV", [(4, 2), (10, 1)])
def test_plain_decode_at_row_positions(window, H, KV):
    B, D, Skv = 4, 16, 100
    q, k, v = _qkv(B, H, KV, D, Skv, seed=H + (window or 0))
    # rows at different positions: one in the first tile, one whose window
    # cuts its live range, the last at the end of the cache
    pos = [3, 40, 71, Skv - 1]
    t = torch.tensor(pos)
    kw = dict(causal=True, window=window)
    got = {
        "torch": flash_attention(q, k, v, q_start=t, impl="torch",
                                 kv_chunk=32, **kw),
        "ref": attention_ref(q, k, v, q_start=t, **kw),
        "split": flash_decode_combine_torch(*flash_decode_partials_torch(
            q, k, v, q_start=t, **kw)),
    }
    for b, p in enumerate(pos):
        row = (q[b:b + 1], k[b:b + 1], v[b:b + 1])
        want = attention_ref(*row, q_start=p, kv_len=p + 1, **kw)
        alone = flash_attention(*row, q_start=torch.tensor(p), impl="torch",
                                kv_chunk=32, **kw)
        assert torch.allclose(alone, want, atol=ATOL, rtol=0), b
        for name, out in got.items():
            assert torch.allclose(out[b:b + 1], want, atol=ATOL, rtol=0), \
                (name, b)
            assert torch.allclose(out[b:b + 1], alone, atol=ATOL, rtol=0), \
                (name, b)


def test_split_partials_at_row_positions_match_rows_alone():
    """Each row's partials at a (B,) position are the row's own at its 0-d
    position, split by the batch's capacity rule (the kernel's one grid)."""
    B, H, KV, D, Skv, window = 3, 8, 2, 16, 160, 40
    q, k, v = _qkv(B, H, KV, D, Skv, seed=5)
    pos = [10, 90, Skv - 1]
    m, l, acc = flash_decode_partials_torch(
        q, k, v, q_start=torch.tensor(pos), window=window)
    S = m.shape[2]
    for b, p in enumerate(pos):
        mb, lb, ab = flash_decode_partials_torch(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], q_start=torch.tensor(p),
            window=window, splits=S)
        assert torch.equal(m[b:b + 1], mb) and torch.equal(l[b:b + 1], lb)
        assert torch.equal(acc[b:b + 1], ab)


# ------------------------------------------------ decode at (B,) rows

def _prefill_rows(tm, params, prompts, smax):
    caches, toks = [], []
    for pr in prompts:
        c = tree_map(lambda t: t.float(), tm.init_cache(1, smax, "cpu"))
        logits, c = tm.prefill_fn(params, c, {"tokens": pr[None]})
        caches.append(c)
        toks.append(int(logits.argmax(-1)))
    return caches, toks


def test_decode_at_row_positions_matches_rows_alone(pair):
    arch, _, tm, _, _, p32 = pair
    smax, steps = 40, 3
    rng = np.random.default_rng(11)
    lens = [5, 9, 20]                  # 20: past Griffin's smoke window
    prompts = [torch.from_numpy(rng.integers(0, tm.cfg.vocab_size, n))
               for n in lens]
    rows, toks = _prefill_rows(tm, p32, prompts, smax)
    B = len(lens)
    axes = [d.logical.index("batch")
            for d in tree_leaves(tm.make_cache_defs(1, smax), is_leaf=is_def)]
    batched = tree_map(lambda t: t.float(), tm.init_cache(B, smax, "cpu"))
    for ax, dst, *src in zip(axes, tree_leaves(batched),
                             *[tree_leaves(c) for c in rows]):
        for b, one in enumerate(src):
            dst.narrow(ax, b, 1).copy_(one)
    bt = list(toks)
    for s in range(steps):
        t = torch.tensor([n + s for n in lens])
        got, batched = tm.decode_fn(p32, batched, torch.tensor(bt)[:, None],
                                    t)
        for b in range(B):
            want, rows[b] = tm.decode_fn(
                p32, rows[b], torch.tensor([[toks[b]]]), lens[b] + s)
            assert torch.allclose(got[b:b + 1], want, atol=ATOL, rtol=0), \
                (arch, s, b)
            toks[b] = int(want.argmax(-1))
        bt = [int(x) for x in got.argmax(-1)]
    for ax, dst, *src in zip(axes, tree_leaves(batched),
                             *[tree_leaves(c) for c in rows]):
        for b, one in enumerate(src):
            assert torch.allclose(dst.narrow(ax, b, 1).float(), one.float(),
                                  atol=ATOL, rtol=0), (arch, b)


# ------------------------------------------------ the server

def _run(srv, model, params, n_req, budget_arenas, arch, step_mode,
         **kw):
    P, GEN = LENS[arch]
    smax = P + GEN
    plan = srv.plan_decode_arena(model, 1, smax)
    reqs = srv.synth_requests(n_req, P, GEN, model.cfg.vocab_size, seed=3)
    m = srv.run_server(model, params, reqs, smax=smax,
                       budget_bytes=int(budget_arenas * plan["arena_bytes"]),
                       step_mode=step_mode, warm=1, **kw)
    return reqs, m


def test_bucket_rounding():
    ns = (1, 2, 3, 4, 5, 8, 9)
    assert [tserve.DecodeServer._bucket(n) for n in ns] == \
        [1, 2, 4, 4, 8, 8, 16] == [jserve.DecodeServer._bucket(n) for n in ns]


def test_padded_bucket_charges_scratch_and_matches_serial(pair):
    arch, _, tm, _, _, p32 = pair
    serial, _ = _run(tserve, tm, p32, 3, 10, arch, "serial", device="cpu")
    reqs, m = _run(tserve, tm, p32, 3, 10, arch, "vmap", device="cpu")
    assert m["n_served"] == 3 and m["max_concurrent"] == 3
    # a batch of 3 pads to the 4-bucket; the padding row's bytes are
    # charged to the budget while the step runs
    assert m["peak_reserved_bytes"] >= 4 * m["arena_bytes"]
    assert [r.tokens for r in reqs] == [r.tokens for r in serial]


def test_exact_batch_when_padding_does_not_fit(pair):
    arch, _, tm, _, _, p32 = pair
    serial, _ = _run(tserve, tm, p32, 3, 10, arch, "serial", device="cpu")
    reqs, m = _run(tserve, tm, p32, 3, 3.0, arch, "vmap", device="cpu")
    assert m["n_served"] == 3 and m["max_concurrent"] == 3
    assert m["peak_reserved_bytes"] <= m["budget_bytes"]
    assert m["max_over_budget_bytes"] <= 0
    assert [r.tokens for r in reqs] == [r.tokens for r in serial]


def test_vmap_requires_naive_accounting(pair):
    _, _, tm, _, tp, _ = pair
    pool = tserve.make_pool(1 << 30, step_mode="serial", pooled=True,
                            device="cpu")
    assert pool.overlap == "serial"
    with pytest.raises(ValueError, match="overlap='none'"):
        tserve.DecodeServer(tm, tp, pool, smax=8, step_mode="vmap",
                            device="cpu")
    assert tserve.make_pool(1 << 30, step_mode="vmap",
                            device="cpu").overlap == "none"


def test_shrink_with_scratch_reserved_sheds_scratch(pair):
    _, _, tm, _, tp, _ = pair
    P, GEN = 4, 3
    smax = P + GEN
    dplan = tserve.plan_decode_arena(tm, 1, smax)
    pool = tserve.make_pool(plan_shared_arena([dplan["plan"]] * 3)
                            .arena_bytes, device="cpu")
    server = tserve.DecodeServer(tm, tp, pool, smax=smax, device="cpu")
    reqs = tserve.synth_requests(2, P, GEN, tm.cfg.vocab_size, seed=7)
    for r in reqs:
        server.submit(r)
    server.step()
    assert len(server.active) == 2
    # e.g. vmap padding rows, held by the server as a token
    server._scratch_token = pool.reserve_scratch(64)
    members = pool.reserved_bytes - pool.scratch_bytes
    # members alone now exceed the new budget: rung 1 is inert (the
    # requests are classless), so rung 2 must shed the scratch and rung 3
    # preempts
    server.set_budget(members - 1)
    assert pool.scratch_bytes == 0 and server._scratch_token is None
    assert server.ladder["shrink_buckets"] == 1
    assert server.ladder["preempt"] >= 1
    assert pool.reserved_bytes <= pool.budget_bytes
    steps = 0
    while (server.active or server._tickets or server._spilled) \
            and steps < 200:
        server.step()
        steps += 1
    assert not (server.active or server._tickets or server._spilled)
    assert all(len(r.tokens) == GEN for r in reqs if not r.rejected)
    assert server.max_over_budget_bytes <= 0


# (requests, budget in naive arenas, concurrency, peak in arenas): 6 under
# 4 arenas queue (buckets 4, then 2); 3 under 10 pad to bucket 4 and
# reserve the padding row; 3 under 3 cannot, and run at the exact batch
SCENARIOS = {"queue": (6, 4, 4, 4), "pad": (3, 10, 3, 4),
             "exact": (3, 3, 3, 3)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_vmap_matches_repro(pair, scenario):
    arch, jm, tm, jp, tp, _ = pair
    n_req, arenas, conc, peak = SCENARIOS[scenario]
    P, GEN = LENS[arch]
    smax = P + GEN
    plan = tserve.plan_decode_arena(tm, 1, smax)
    budget = arenas * plan["arena_bytes"]
    kw = dict(smax=smax, budget_bytes=budget, step_mode="vmap", warm=2)
    jreqs = jserve.synth_requests(n_req, P, GEN, 512, seed=1)
    treqs = tserve.synth_requests(n_req, P, GEN, 512, seed=1)
    jm_ = jserve.run_server(jm, jp, jreqs, **kw)
    tm_ = tserve.run_server(tm, tp, treqs, device="cpu", **kw)
    assert tm_["max_concurrent"] == conc
    assert tm_["peak_reserved_bytes"] == peak * plan["arena_bytes"]
    for k in METRICS + ("ladder", "reject_codes", "max_over_budget_bytes"):
        assert tm_[k] == jm_[k], k
    steps = [jax.jit(lambda *a, f=f: f(*a, impl="xla"))
             for f in (jm.prefill_fn, jm.decode_fn)]
    # equal up to a first divergence, which only a tie may cause (the two
    # requests then decode different inputs); most tokens before it
    matched = 0
    for a, b in zip(jreqs, treqs):
        assert (a.rid, a.rejected) == (b.rid, b.rejected)
        margins = _reference_margins(jm, jp, a.prompt, list(a.tokens),
                                     *steps)
        for s, m in enumerate(margins):
            if b.tokens[s] != a.tokens[s]:
                assert m <= TIES[arch], (a.rid, s, m)
                break
            matched += 1
    assert matched >= len(jreqs) * GEN // 2, matched


def test_captured_batched_step_raises_on_cpu(pair):
    _, _, tm, _, tp, _ = pair
    with pytest.raises(ValueError, match="CUDA"):
        CapturedBatchedDecodeStep(tm, tp, bucket=2, smax=8, device="cpu")


def test_drain_keeps_one_bucket_step(pair):
    """Requests that finish at different ticks drain the batch through
    buckets 4, 2 and 1: each new bucket frees the previous bucket's step
    and its static cache at once, with the garbage collector off (no
    reference cycle holds them), so one bucket's state stays resident; the
    tokens are the serial run's."""
    arch, _, tm, _, _, p32 = pair
    P, GEN = LENS[arch]

    def serve(step_mode):
        pool = tserve.make_pool(1 << 30, step_mode=step_mode, device="cpu")
        server = tserve.DecodeServer(tm, p32, pool, smax=P + GEN + 2,
                                     step_mode=step_mode, device="cpu")
        reqs = tserve.synth_requests(4, P, GEN, tm.cfg.vocab_size, seed=11)
        for r, extra in zip(reqs, (2, 1, 0, -1)):
            r.max_new = GEN + extra
            server.submit(r)
        buckets, freed = [], []
        gc.collect()
        gc.disable()
        try:
            while server.active or server._tickets:
                old = server._batched
                gone = [] if old is None else [weakref.ref(x) for x in
                                               (old, *tree_leaves(old.cache))]
                del old
                server.step()
                step = server._batched
                if step is not None and (not buckets
                                         or step.bucket != buckets[-1]):
                    buckets.append(step.bucket)
                    freed.append(all(g() is None for g in gone))
                del step
        finally:
            gc.enable()
        return reqs, buckets, freed

    serial, _, _ = serve("serial")
    reqs, buckets, freed = serve("vmap")
    assert buckets == [4, 2, 1] and freed == [True] * 3
    assert [r.tokens for r in reqs] == [r.tokens for r in serial]
    assert [len(r.tokens) for r in reqs] == [GEN + 2, GEN + 1, GEN, GEN - 1]
