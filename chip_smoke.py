#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout.  It needs one CUDA card, ``nvcc`` and
nothing of JAX.  Phases, each fatal (an exception or a failed check exits
non-zero):

1. build   -- compile ``src/repro_torch/csrc/arena.cu`` and
              ``flash_attention.cu`` (nvcc, sm_90a, both started together)
              and print the build seconds of each, the card's name and
              power limit;
2. kernels -- hold each arena kernel against its plain PyTorch version on
              the card: awkward offsets and lengths (0, 1, 3, 4097 and
              150,528, the largest tensor of the DARTS cell), f32 and u8;
              write/read/accum and the exact chain ops bit-equal, the
              transcendental chain ops allclose; n == 0 launches nothing;
3. flash   -- hold the flash-attention kernel against its plain PyTorch
              version (``impl="torch"``) and the oracle (``impl="ref"``) on
              the card: bf16 and f32, every (D, Dv) the wrapper takes
              (16/16, 64/64, 128/128, 192/128), GQA groups 1 and 4, decode
              over caches of 1/127/1056/4097 keys, causal prefill of
              1/33/1024 tokens, a sliding window, non-causal attention (with
              a window, and against a partly filled cache), and a cache
              whose tail beyond kv_len holds garbage that must not leak;
              f32 within rtol 1e-5 + atol 1e-5, bf16 within one bf16 ulp of
              the output + 1e-5;
4. main    -- plan every paper graph and full network with SERENITY and
              execute it in one arena on the card, slice-per-node and fused:
              realized == planned bytes, slice path bit-equal to
              ``run_reference`` on the card, fused path bit-equal where every
              fused chain is exact (else allclose), the planner's known
              integers, a uint8 pack/unpack round trip, and each of the four
              kernels launched > 0 times over the run;
5. serve   -- the serving path: ``llama3.2-1b`` at its published width
              (random weights from a seed) behind ``run_server``, 4 requests
              of 1024 prompt tokens and 32 generated ones under the CLI's
              default budget: the decode plan's integers, 4 served and 128
              tokens, tokens bit-equal to a prefill + decode loop that keeps
              the cache as plain tensors, the first decode steps' logits of
              the kernel allclose to the plain version's, the launches of
              the flash kernel and the u8 arena write/read over the run, and
              one prefilled cache packed and unpacked at the served plan by
              the u8 kernels bit-equal to their plain versions;
6. timing  -- microseconds per ``execute`` of the two full networks, and per
              kernel at the launches the main paths made: the kernel, its
              bound, its plain version and the one torch call that computes
              the same (a yardstick, never called by the port); serving's
              prefill ms per request, ms per decode token, the device's busy
              time and idle share over one decode step and its launches,
              and the u8 arena write/read at the served leaves' sizes.

The second-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a
checkout, it exits non-zero before printing either.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak, same sheet
SIZES = (0, 1, 3, 4097, 150528)    # 150,528 f32 = 28x28x48x4 B: DARTS fmap
CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-6  # expf/tanhf vs torch's eager kernels
SEED = 0

# file:line of the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "write": "src/repro/kernels/arena/kernel.py:65",
    "read": "src/repro/kernels/arena/kernel.py:89",
    "accum": "src/repro/kernels/arena/kernel.py:77",
    "chain_write": "src/repro/kernels/arena/kernel.py:100",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:109",
}
FA_RTOL32 = FA_ATOL32 = 1e-5       # f32: sums in another order
FA_ATOL16 = 1e-5                   # bf16: + one ulp of the output
# serving: llama3.2-1b at full width, the decode plan's known integers
ARCH, PROMPT, GEN, N_REQ = "llama3.2-1b", 1024, 32, 4
PLAN_INTS = {"arena_bytes": 35_124_228, "resident_extent": 34_603_012,
             "transient_bytes": 521_216, "n_buffers": 53}
LOGIT_STEPS, LOGIT_ATOL = 8, 5e-2  # bf16 logits of 16 layers, |logit| ~ 1


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(dev, rng, err):
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R
    from repro_torch.kernels.arena.elemwise import ELEMWISE_OP_CODES, EXACT_OPS

    def arena_and_x(n, dtype):
        pad = int(rng.integers(0, 97))
        size = n + pad + int(rng.integers(0, 65))
        if dtype == torch.uint8:
            a = rng.integers(0, 256, size, dtype=np.uint8)
            x = rng.integers(0, 256, n, dtype=np.uint8)
        else:
            a = rng.standard_normal(size).astype(np.float32)
            x = (3 * rng.standard_normal(n)).astype(np.float32)
        return (torch.from_numpy(a).to(dev), torch.from_numpy(x).to(dev), pad)

    def record(name, got, want):
        e = 0.0 if got.numel() == 0 else float(
            (got.double() - want.double()).abs().max())
        err[name] = max(err[name], e)
        return e

    for dtype in (torch.float32, torch.uint8):
        for n in SIZES:
            a, x, o = arena_and_x(n, dtype)
            got = K.arena_write_cuda(a.clone(), x, o)
            want = R.arena_write_torch(a.clone(), x, o)
            record("write", got, want)
            check(torch.equal(got, want), f"write {dtype} n={n}")
            got = K.arena_read_cuda(a, o, n)
            want = R.arena_read_torch(a, o, n)
            record("read", got, want)
            check(torch.equal(got, want), f"read {dtype} n={n}")
            check(n == 0 or got.data_ptr() != a.data_ptr(),
                  "read returned a view")
    for n in SIZES:
        a, x, o = arena_and_x(n, torch.float32)
        got = K.arena_accum_cuda(a.clone(), x, o)
        want = R.arena_accum_torch(a.clone(), x, o)
        record("accum", got, want)
        check(torch.equal(got, want), f"accum n={n}")

    chains = [(op,) for op in ELEMWISE_OP_CODES] + [
        ("relu", "bn"), ("bn", "relu"), ("relu", "bn", "relu", "bn"),
        ("bn", "scale", "bias_add", "relu6"), ("gelu", "silu", "tanh")]
    worst_transcendental = 0.0
    for ops in chains:
        for n in SIZES:
            a, x, o = arena_and_x(n, torch.float32)
            got = K.arena_chain_write_cuda(a.clone(), x, o, ops)
            want = R.arena_chain_write_torch(a.clone(), x, o, ops)
            e = record("chain_write", got, want)
            if set(ops) <= EXACT_OPS:
                check(torch.equal(got, want), f"chain_write {ops} n={n}")
            else:
                worst_transcendental = max(worst_transcendental, e)
                check(torch.allclose(got, want, rtol=CHAIN_RTOL,
                                     atol=CHAIN_ATOL),
                      f"chain_write {ops} n={n}: max abs err {e}")
    torch.cuda.synchronize()

    K.reset_launches()
    a, x, _ = arena_and_x(0, torch.float32)
    K.arena_write_cuda(a, x, 0)
    K.arena_accum_cuda(a, x, 0)
    K.arena_chain_write_cuda(a, x, 0, ("relu",))
    check(K.arena_read_cuda(a, 0, 0).numel() == 0, "read n=0")
    check(all(v == 0 for v in K.LAUNCHES.values()),
          f"n == 0 launched a kernel: {K.LAUNCHES}")
    say(f"kernels: write/read f32+u8, accum, exact chains bit-equal at "
        f"n in {SIZES}; transcendental chains max abs err "
        f"{worst_transcendental:.3e} (rtol {CHAIN_RTOL}, atol {CHAIN_ATOL}); "
        f"n == 0 launches nothing")


# ---------------------------------------------------------------------------
# Phase 3: the flash-attention kernel against its plain versions
# ---------------------------------------------------------------------------


def bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (f32): 2^(e - 8) for
    x = m * 2^e, 0.5 <= m < 1."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def fa_err(got, want):
    """(max abs err, within tolerance) of two outputs of one dtype."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    if got.dtype == torch.float32:
        ok = bool((diff <= FA_ATOL32 + FA_RTOL32 * b.abs()).all())
    else:
        ok = bool((diff <= bf16_ulp(torch.maximum(a.abs(), b.abs()))
                   + FA_ATOL16).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def phase_flash(dev, err):
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED)
    KV = 8
    cases = []
    for kv in (1, 127, 1056, 4097):        # decode: one query at kv_len - 1
        cases.append(("decode", 1, kv, dict(q_start=kv - 1, kv_len=kv)))
    for n in (1, 33, 1024):                # causal prefill
        cases.append(("prefill", n, n, dict()))
    cases.append(("window", 100, 100, dict(window=17)))
    cases.append(("tail", 1, 1056, dict(q_start=499, kv_len=500)))
    cases.append(("noncausal", 33, 100, dict(causal=False)))
    cases.append(("noncausal window", 64, 64, dict(causal=False, window=9)))
    cases.append(("noncausal tail", 5, 1056, dict(causal=False, q_start=3,
                                                  kv_len=700)))
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for D, Dv in FK.HEAD_DIMS:        # every (D, Dv) the wrapper takes
            for G in (1, 4):
                H = KV * G
                for name, sq, skv, kw in cases:
                    q = torch.randn(1, sq, H, D, device=dev,
                                    generator=gen).to(dtype)
                    k = torch.randn(1, skv, KV, D, device=dev,
                                    generator=gen).to(dtype)
                    v = torch.randn(1, skv, KV, Dv, device=dev,
                                    generator=gen).to(dtype)
                    got = FK.flash_attention_cuda(
                        q, k, v, causal=kw.get("causal", True),
                        window=kw.get("window"),
                        q_start=kw.get("q_start", 0),
                        kv_len=kw.get("kv_len", skv))
                    line = []
                    for impl in ("torch", "ref"):
                        want = flash_attention(q, k, v, impl=impl, **kw)
                        e, ok = fa_err(got, want)
                        check(ok, f"flash {name} {dtype} D={D} Dv={Dv} "
                                  f"G={G} vs {impl}: max abs err {e}")
                        err["flash_attention"] = max(err["flash_attention"],
                                                     e)
                        key = (str(dtype).split(".")[1], impl)
                        worst[key] = max(worst.get(key, 0.0), e)
                        line.append(f"{impl} {e:.3e}")
                    if name.endswith("tail"):
                        # finite garbage beyond kv_len must not leak
                        k[:, kw["kv_len"]:] = 1e4
                        v[:, kw["kv_len"]:] = -1e4
                        dirty = FK.flash_attention_cuda(
                            q, k, v, causal=kw.get("causal", True),
                            window=None, q_start=kw["q_start"],
                            kv_len=kw["kv_len"])
                        check(torch.equal(dirty, got),
                              f"flash {name} {dtype} D={D} Dv={Dv} G={G}: "
                              f"garbage beyond kv_len leaked")
                    say(f"flash: {name} Sq {sq} Skv {skv} {kw} "
                        f"{str(dtype).split('.')[1]} D {D} Dv {Dv} G {G}: "
                        f"max abs err vs {', '.join(line)}")
    torch.cuda.synchronize()
    say(f"flash: every case within tolerance (f32 rtol {FA_RTOL32} + atol "
        f"{FA_ATOL32}; bf16 one ulp of the output + {FA_ATOL16}); worst "
        + ", ".join(f"{d} vs {i} {e:.3e}" for (d, i), e in worst.items()))


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def seeded_inputs(g, rng):
    from repro_torch.core.executor import input_nodes
    return {g.nodes[u].name: rng.standard_normal(g.sizes[u] // 4)
            .astype(np.float32) for u in input_nodes(g)}


def phase_main(rng):
    import repro_torch as rt
    from repro_torch.graphs import BENCHMARK_GRAPHS, FULL_NETWORKS, swiftnet_cell
    from repro_torch.kernels.arena import LAUNCHES, reset_launches
    from repro_torch.kernels.arena.elemwise import EXACT_OPS

    # the planner integers known from the JAX package
    g = swiftnet_cell("A")
    plain = rt.plan(g, rt.PlanConfig(rewrite=False))
    rew = rt.plan(g, rt.PlanConfig())
    peaks = (plain.baseline_peaks["kahn"], plain.peak_bytes, rew.peak_bytes)
    check(peaks == (3920 * 1024, 3038 * 1024, 2744 * 1024),
          f"swiftnet_cell_a peaks {peaks}")
    say(f"planner: swiftnet_cell_a TFLite {peaks[0]} B -> SERENITY "
        f"{peaks[1]} B -> rewrite {peaks[2]} B")

    graphs = {**BENCHMARK_GRAPHS, **FULL_NETWORKS}
    plans = {name: rt.plan(mk(), rt.PlanConfig()) for name, mk in graphs.items()}
    inputs = {name: seeded_inputs(p.graph, rng) for name, p in plans.items()}

    reset_launches()
    per_graph = {}
    for name, p in plans.items():
        before = dict(LAUNCHES)
        ref = rt.run_reference(p.graph, inputs[name])
        for fuse in (False, True):
            res = rt.execute(p.graph, inputs[name], p.arena, order=p.order,
                             fuse=fuse)
            check(res.realized_matches_plan
                  and res.realized_peak_bytes == p.peak_bytes
                  and res.realized_arena_bytes == p.arena_bytes,
                  f"{name} fuse={fuse}: realized != planned")
            check(set(res.outputs) == set(ref), f"{name}: output names")
            prog = rt.compile_plan(p.graph, p.order, p.arena, fuse=fuse)
            exact = all(set(ops) <= EXACT_OPS
                        for _, ops, _ in prog._groups.values())
            for k, v in ref.items():
                got = res.outputs[k]
                check(got.shape == v.shape and bool(torch.isfinite(got).all()),
                      f"{name}: output {k} shape or finiteness")
                if not fuse or exact:
                    check(torch.equal(got, v),
                          f"{name} fuse={fuse}: {k} not bit-equal to "
                          f"run_reference")
                else:
                    check(torch.allclose(got, v, rtol=CHAIN_RTOL,
                                         atol=CHAIN_ATOL),
                          f"{name} fuse={fuse}: {k} not allclose")
            if name == "darts_imagenet_cell" and fuse:
                counts = (prog.n_regions, prog.n_fused_nodes,
                          max(len(r) for r in prog.regions))
                check(counts == (31, 23, 4), f"darts fusion counts {counts}")
        torch.cuda.synchronize()
        per_graph[name] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        say(f"main: {name}: {len(p.graph)} nodes, peak {p.peak_bytes} B, "
            f"arena {p.arena_bytes} B, realized == planned (slice, fused), "
            f"slice bit-equal to run_reference, fused "
            f"{'bit-equal' if exact else 'allclose'}; launches {per_graph[name]}")

    # serving-state packing: mixed dtypes through the uint8 write/read
    p = plans["darts_imagenet_cell"]
    ids, taken = [], []     # nodes whose first 64 bytes overlap no other's
    for u in p.order:
        o = p.arena.offset_of(u)
        if p.graph.sizes[u] >= 64 and len(ids) < 4 and \
                all(o + 64 <= t or t + 64 <= o for t in taken):
            ids.append(u)
            taken.append(o)
    dts = (torch.float32, torch.int32, torch.float16, torch.uint8)
    arrays = {u: torch.from_numpy(rng.integers(0, 100, 16)).to(dt)
              for u, dt in zip(ids, dts)}
    packed = rt.pack_buffers(p.arena, arrays)
    for u, x in arrays.items():
        back = rt.unpack_buffer(packed, p.arena, u, x.shape, x.dtype)
        check(torch.equal(back.cpu(), x), f"pack/unpack node {u} {x.dtype}")
    torch.cuda.synchronize()

    launches = dict(LAUNCHES)
    say(f"main: launches over the run {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was never launched: {launches}")
    return plans, inputs, launches, per_graph


# ---------------------------------------------------------------------------
# Phase 5: serving llama3.2-1b at full width
# ---------------------------------------------------------------------------


def reset_all():
    from repro_torch.kernels.arena import reset_launches as arena_reset
    from repro_torch.kernels.flash_attention import reset_launches as fa_reset
    arena_reset()
    fa_reset()


def all_launches() -> dict:
    from repro_torch.kernels.arena import LAUNCHES as AL
    from repro_torch.kernels.flash_attention import LAUNCHES as FL
    return {**AL, **FL}


def direct_decode(model, params, prompt, n_steps, dev, *, impl="auto",
                  forced=None):
    """Prefill + ``n_steps`` greedy decode steps with the cache kept as
    plain tensors (no arena); returns (tokens, per-step logits).  With
    ``forced``, step s feeds token ``forced[s]`` instead of its own."""
    smax = PROMPT + GEN
    cache = model.init_cache(1, smax, dev)
    tokens = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    logits, cache = model.prefill_fn(params, cache, {"tokens": tokens},
                                     impl=impl)
    toks, outs = [int(torch.argmax(logits, -1)[0])], [logits]
    for s in range(n_steps):
        tok = toks[-1] if forced is None else forced[s]
        t = torch.full((1, 1), tok, dtype=torch.long, device=dev)
        logits, cache = model.decode_fn(params, cache, t, PROMPT + s,
                                        impl=impl)
        toks.append(int(torch.argmax(logits, -1)[0]))
        outs.append(logits)
    return toks, outs


def check_served_packing(model, params, plan, req, dev):
    """The u8 arena kernels at the served sizes: one request's prefilled
    cache packed into an arena of the plan's resident extent (random bytes
    to start with) by the kernels and by their plain versions must give the
    same arena, with each leaf's bytes at its planned offset; unpacking it
    both ways must give the leaves back, bit for bit."""
    from repro_torch.core.executor import pack_buffers, unpack_buffer
    from repro_torch.models.params import tree_leaves

    cache = model.init_cache(1, PROMPT + GEN, dev)
    tokens = torch.as_tensor(req.prompt, dtype=torch.long, device=dev)[None]
    _, cache = model.prefill_fn(params, cache, {"tokens": tokens})
    leaves = dict(enumerate(tree_leaves(cache)))
    apl = plan["plan"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    start = torch.randint(0, 256, (plan["resident_extent"],),
                          dtype=torch.uint8, device=dev, generator=gen)
    packed = {impl: pack_buffers(apl, leaves, arena=start.clone(), impl=impl,
                                 device=dev) for impl in ("cuda", "torch")}
    torch.cuda.synchronize()
    check(torch.equal(packed["cuda"], packed["torch"]),
          "served cache: the u8 write kernel's arena differs from the plain "
          "version's")
    spans = []
    for i, leaf in leaves.items():
        raw = leaf.reshape(-1).view(torch.uint8)
        o, n = apl.offset_of(i), raw.numel()
        spans.append((o, n))
        check(torch.equal(packed["cuda"][o:o + n], raw),
              f"served cache leaf {i}: bytes not at planned offset {o}")
        backs = {impl: unpack_buffer(packed["cuda"], apl, i, leaf.shape,
                                     leaf.dtype, impl=impl)
                 for impl in ("cuda", "torch")}
        for impl, back in backs.items():
            check(back.dtype == leaf.dtype and torch.equal(
                back.reshape(-1).view(torch.uint8), raw),
                f"served cache leaf {i}: unpacked by {impl} != the leaf")
    torch.cuda.synchronize()
    say(f"serve: one prefilled cache packed into {plan['resident_extent']} "
        f"B by the u8 write kernel and by its plain version: arenas "
        f"bit-equal, leaves (offset, bytes) {spans} at their planned "
        f"offsets; unpacked by the u8 read kernel and by its plain version: "
        f"bit-equal to the leaves")
    return spans


def phase_serve(dev):
    import repro_torch.configs as configs
    from repro_torch.launch import serve as S
    from repro_torch.models.params import leaf_count, tree_leaves
    from repro_torch.models.zoo import build_model

    cfg = configs.get(ARCH)
    model = build_model(cfg)
    smax = PROMPT + GEN
    plan = S.plan_decode_arena(model, 1, smax)
    got = {k: plan[k] for k in PLAN_INTS}
    check(got == PLAN_INTS, f"decode plan {got} != reference {PLAN_INTS}")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == leaf_count(model.defs),
          f"{n_params} parameters made, {leaf_count(model.defs)} defined")
    say(f"serve: {ARCH} at full width, {n_params} parameters in bf16 "
        f"({cfg.param_count()} without the norm scales) made on the card "
        f"in {time.perf_counter() - t0:.3f} s; decode plan {got}, policy "
        f"{plan['policy']} (the reference's integers)")

    budget = 4 * plan["arena_bytes"]      # the CLI's default budget
    reqs = S.synth_requests(N_REQ, PROMPT, GEN, cfg.vocab_size, SEED + 1)
    reset_all()
    m = S.run_server(model, params, reqs, smax=smax, budget_bytes=budget,
                     warm=2)
    torch.cuda.synchronize()
    launches = all_launches()
    say(f"serve: {m['n_served']}/{m['n_requests']} served, "
        f"{m['n_rejected']} rejected, {m['n_tokens']} tokens in "
        f"{m['wall_s']:.2f} s over {m['steps']} ticks, concurrency "
        f"{m['max_concurrent']} under {budget} B; launches over the run "
        f"{launches}")
    check(m["n_served"] == N_REQ and m["n_rejected"] == 0
          and m["n_tokens"] == N_REQ * GEN,
          f"served {m['n_served']}, rejected {m['n_rejected']}, "
          f"{m['n_tokens']} tokens")
    # per request: prefill 16 layers, then GEN - 1 decode steps of 16; each
    # prefill packs k and v once, each decode step unpacks and packs them
    steps = N_REQ * (GEN - 1)
    want = {"flash_attention": N_REQ * cfg.n_layers * GEN,
            "write": 2 * (N_REQ + steps), "read": 2 * steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times, the "
                                f"serving path needs {n}")
    spans = check_served_packing(model, params, plan, reqs[0], dev)

    for r in reqs:
        toks, _ = direct_decode(model, params, r.prompt, GEN - 1, dev)
        check(toks == list(r.tokens),
              f"request {r.rid}: server tokens differ from the arena-free "
              f"loop")
    toks, auto = direct_decode(model, params, reqs[0].prompt, LOGIT_STEPS,
                               dev)
    _, plain = direct_decode(model, params, reqs[0].prompt, LOGIT_STEPS, dev,
                             impl="torch", forced=toks[:LOGIT_STEPS])
    e = max(float((a - b).abs().max()) for a, b in zip(auto, plain))
    peak = max(float(a.abs().max()) for a in auto)
    check(all(bool(torch.isfinite(a).all()) and a.shape == (1, cfg.vocab_size)
              for a in auto), "logits not finite or of the wrong shape")
    check(e <= LOGIT_ATOL, f"logits of the kernel vs the plain attention: "
                           f"max abs err {e} > {LOGIT_ATOL}")
    say(f"serve: tokens of all {N_REQ} requests bit-equal to the arena-free "
        f"prefill + decode loop; prefill + {LOGIT_STEPS} decode steps' "
        f"logits, kernel vs plain attention: max abs err {e:.3e} (atol "
        f"{LOGIT_ATOL}; max |logit| {peak:.3f})")
    return model, params, plan, reqs, launches, spans


# ---------------------------------------------------------------------------
# Phase 6: timings
# ---------------------------------------------------------------------------


def device_profile(work) -> tuple[float, int, dict]:
    """(microseconds, activities, {name: [us, count]}) of the card during
    ``work()``: the kernels and copies of a ``torch.profiler`` trace,
    summed and counted, in all and by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in evs:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.elapsed_us()
        acc[1] += 1
    us = sum(t for t, _ in by_name.values())
    check(us > 0, "the profiler saw no device activity")
    return us, len(evs), by_name


def device_us(work) -> float:
    """Microseconds the card spent running kernels (and copies) during
    ``work()``."""
    return device_profile(work)[0]


def time_execute(rt, p, inputs, fuse, reps=20):
    """(median, min) host-clock us per execute, and device-busy us per
    execute, with the inputs already on the card."""
    dev_inputs = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}

    def run():
        rt.execute(p.graph, dev_inputs, p.arena, order=p.order, fuse=fuse)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    us = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) * 1e6)
    busy = device_us(lambda: [run() for _ in range(3)]) / 3
    return statistics.median(us), min(us), busy


def record_launches(rt, plans, inputs):
    """The (kernel, arena elements, offset, n, ops) of every launch one
    execute of each full network makes, slice and fused."""
    from repro_torch.kernels.arena import kernel as K
    log = []
    names = ("write", "read", "accum", "chain_write")
    orig = {nm: getattr(K, f"arena_{nm}_cuda") for nm in names}

    def rec(nm):
        def wrapped(arena, *args):
            if nm == "read":
                offset, n = args
                log.append((nm, arena.shape[0], offset, n, ()))
            else:
                x, offset, *ops = args
                log.append((nm, arena.shape[0], offset, x.shape[0],
                            tuple(ops[0]) if ops else ()))
            return orig[nm](arena, *args)
        return wrapped

    try:
        for nm in names:
            setattr(K, f"arena_{nm}_cuda", rec(nm))
        for name in ("darts_net_x6", "randwire_net_32x8"):
            p = plans[name]
            for fuse in (False, True):
                rt.execute(p.graph, inputs[name], p.arena, order=p.order,
                           fuse=fuse)
    finally:
        for nm in names:
            setattr(K, f"arena_{nm}_cuda", orig[nm])
    torch.cuda.synchronize()
    return [e for e in log if e[3] > 0]


def time_replay(launches_of, fn, reps=20):
    """(device ms, host-clock ms) per launch of ``fn`` over the recorded
    launches: the card's own time from the profiler, and the time per call
    with the host's issue cost, from CUDA events around ``reps`` passes."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def one_pass():
        for args in launches_of:
            fn(*args)

    for _ in range(2):
        one_pass()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        one_pass()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / (reps * len(launches_of))
    dev_ms = device_us(one_pass) / 1e3 / len(launches_of)
    return dev_ms, call_ms


def phase_timing(plans, inputs, launches, err, card):
    import repro_torch as rt
    from repro_torch.kernels.arena import LAUNCHES, reset_launches
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    for name in ("darts_net_x6", "randwire_net_32x8"):
        p = plans[name]
        for fuse in (False, True):
            reset_launches()
            rt.execute(p.graph, inputs[name], p.arena, order=p.order,
                       fuse=fuse)
            torch.cuda.synchronize()
            per_exec = dict(LAUNCHES)
            med, best, busy = time_execute(rt, p, inputs[name], fuse)
            say(f"timing: execute {name} {'fused' if fuse else 'slice'}: "
                f"median {med:.1f} us, min {best:.1f} us per execute "
                f"(host clock); device busy {busy:.1f} us per execute, "
                f"idle share {1 - busy / med:.4f}; arena kernel launches "
                f"per execute {per_exec} [{card}]")

    log = record_launches(rt, plans, inputs)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    arena_elems = max(e[1] for e in log)
    arena = torch.randn(arena_elems, device=dev, generator=gen)
    xs = {}

    def x_of(n):
        if n not in xs:
            xs[n] = torch.randn(n, device=dev, generator=gen)
        return xs[n]

    impls = {
        "write": (K.arena_write_cuda, R.arena_write_torch,
                  lambda a, x, o: a[o:o + x.shape[0]].copy_(x)),
        "read": (K.arena_read_cuda, R.arena_read_torch,
                 lambda a, o, n: a[o:o + n].clone()),
        "accum": (K.arena_accum_cuda, R.arena_accum_torch,
                  lambda a, x, o: a[o:o + x.shape[0]].add_(x)),
        "chain_write": (K.arena_chain_write_cuda, R.arena_chain_write_torch,
                        None),
    }
    # bytes each launch must move: inputs read once, outputs written once
    per_elem = {"write": 8, "read": 8, "accum": 12, "chain_write": 8}
    rows = []
    for name, (kern, plain, lib) in impls.items():
        recs = [e for e in log if e[0] == name]
        check(len(recs) > 0, f"no recorded launches of {name}")
        if name == "read":
            args = [(arena, o, n) for _, _, o, n, _ in recs]
        elif name == "chain_write":
            args = [(arena, x_of(n), o, ops) for _, _, o, n, ops in recs]
        else:
            args = [(arena, x_of(n), o) for _, _, o, n, _ in recs]
        ms, call_ms = time_replay(args, kern)
        plain_ms, plain_call_ms = time_replay(args, plain)
        lib_ms, lib_call_ms = (None, None) if lib is None \
            else time_replay(args, lib)
        mean_bytes = per_elem[name] * sum(r[3] for r in recs) / len(recs)
        bound_ms = mean_bytes / HBM_BYTES_PER_S * 1e3
        say(f"timing: {name}: {len(recs)} launches at the main path's shapes "
            f"(mean n {mean_bytes / per_elem[name]:.0f}); device us per "
            f"launch: kernel {ms * 1e3:.3f}, bound {bound_ms * 1e3:.3f} "
            f"(bytes), plain {plain_ms * 1e3:.3f}, torch call "
            f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:.3f}'}; host-clock "
            f"us per call: kernel {call_ms * 1e3:.2f}, plain "
            f"{plain_call_ms * 1e3:.2f}, torch call "
            f"{'n/a' if lib_call_ms is None else f'{lib_call_ms * 1e3:.2f}'} "
            f"[{card}]")
        rows.append(dict(
            name=f"arena_{name}", route="cuda",
            source="src/repro_torch/csrc/arena.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms))
    return rows


def fa_bound(q, k, v, kw) -> tuple[float, float]:
    """(bytes ms, operations ms) the card needs at least for one attention
    call: q, k and v read once for the kv_len live keys, the output written
    once, over 3.35 TB/s; 2*2*H*D flops per live (query, key) pair over the
    bf16 tensor-core peak."""
    B, Sq, H, D = q.shape
    n, qs = kw["kv_len"], kw["q_start"]
    live = sum(min(n, qs + i + 1) for i in range(Sq))     # causal pairs
    esz = q.element_size()
    nbytes = esz * (2 * q.numel() + 2 * B * n * k.shape[2] * D)
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            4 * B * H * D * live / BF16_FLOP_PER_S * 1e3)


def time_served_packing(plan, spans, by_name, card, dev):
    """The u8 arena write/read at the served cache leaves' offsets and
    sizes: their device us in the decode token's trace, and replayed
    against their bound, their plain versions and one torch copy."""
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    arena = torch.randint(0, 256, (plan["resident_extent"],),
                          dtype=torch.uint8, device=dev, generator=gen)
    xs = [torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                        generator=gen) for _, n in spans]
    impls = {
        "write": ([(arena, x, o) for x, (o, _) in zip(xs, spans)],
                  K.arena_write_cuda, R.arena_write_torch,
                  lambda a, x, o: a[o:o + x.shape[0]].copy_(x)),
        "read": ([(arena, o, n) for o, n in spans],
                 K.arena_read_cuda, R.arena_read_torch,
                 lambda a, o, n: a[o:o + n].clone()),
    }
    for name, (args, kern, plain, lib) in impls.items():
        traced = [v for k, v in by_name.items()
                  if f"{name}_kernel<unsigned char" in k]
        t_us, t_n = sum(v[0] for v in traced), sum(v[1] for v in traced)
        ms = time_replay(args, kern)[0]
        plain_ms, lib_ms = time_replay(args, plain)[0], \
            time_replay(args, lib)[0]
        mean_n = sum(n for _, n in spans) / len(spans)
        bound_ms = 2 * mean_n / HBM_BYTES_PER_S * 1e3
        say(f"timing: serve u8 arena {name} at the served leaves "
            f"{spans}: in the decode token's trace {t_n} launches, "
            f"{t_us:.1f} us in all; replayed, device us per launch: kernel "
            f"{ms * 1e3:.2f}, bound {bound_ms * 1e3:.2f} (bytes, "
            f"{2 * mean_n:.0f} B), plain {plain_ms * 1e3:.2f}, torch call "
            f"{lib_ms * 1e3:.2f} [{card}]")


def phase_serve_timing(model, params, plan, reqs, spans, launches, err,
                       card, dev):
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_prefill_step

    cfg, smax = model.cfg, PROMPT + GEN
    prefill = make_prefill_step(model)
    batch = {"tokens": torch.as_tensor(reqs[0].prompt, dtype=torch.long,
                                       device=dev)[None]}
    ms = []
    for _ in range(4):
        cache = model.init_cache(1, smax, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, cache, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(ms[1:])

    # decode through the server: one request in flight, one token a tick
    pool = S.make_pool(4 * plan["arena_bytes"])
    server = S.DecodeServer(model, params, pool, smax=smax)
    server.submit(S.Request(rid=0, prompt=reqs[0].prompt, max_new=GEN))
    server.step()                  # admit + prefill + the first decode
    ms = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    tok_ms = statistics.median(ms)
    reset_all()
    busy_us, n_dev, by_name = device_profile(server.step)
    per_tok = all_launches()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    say(f"timing: serve {ARCH}: prefill {prefill_ms:.2f} ms per request of "
        f"{PROMPT} tokens (median of 3, host clock); decode {tok_ms:.3f} ms "
        f"per token (median of 8 ticks, min {min(ms):.3f}, one request in "
        f"flight, host clock); device busy {busy_us:.1f} us per token, idle "
        f"share {1 - busy_us / (tok_ms * 1e3):.4f}; {n_dev} device "
        f"activities per token, of them the port's kernels {per_tok} "
        f"[{card}]")
    say("timing: serve decode token, device us by kernel (count): "
        + "; ".join(f"{name[:60]} {t:.1f} ({n})" for name, (t, n) in top))
    time_served_packing(plan, spans, by_name, card, dev)

    # the flash kernel at the serving path's shapes
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    dec = (rnd(1, 1, H, D), rnd(1, smax, KV, D), rnd(1, smax, KV, D))
    pre = (rnd(1, PROMPT, H, D), rnd(1, PROMPT, KV, D), rnd(1, PROMPT, KV, D))
    impls = {
        "kernel": lambda q, k, v, kw: FK.flash_attention_cuda(
            q, k, v, causal=True, window=None, **kw),
        "plain": lambda q, k, v, kw: flash_attention(q, k, v, impl="torch",
                                                     **kw),
        "sdpa": lambda q, k, v, kw: F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :kw["kv_len"]].transpose(1, 2),
            v[:, :kw["kv_len"]].transpose(1, 2), is_causal=q.shape[1] > 1,
            enable_gqa=True),
    }
    shapes = {"decode": (*dec, dict(q_start=smax - 1, kv_len=smax)),
              "prefill": (*pre, dict(q_start=0, kv_len=PROMPT))}
    for name, args in shapes.items():
        t = {i: time_replay([args], fn) for i, fn in impls.items()}
        b_ms, o_ms = fa_bound(*args)
        e = float((impls["kernel"](*args).float()
                   - impls["sdpa"](*args).transpose(1, 2).float())
                  .abs().max())
        q = args[0]
        say(f"timing: flash_attention {name} (B 1, Sq {q.shape[1]}, Skv "
            f"{args[1].shape[1]}, H {H}, KV {KV}, D {D}, bf16, "
            f"{args[3]}): device us per launch: kernel "
            f"{t['kernel'][0] * 1e3:.2f}, bound {max(b_ms, o_ms) * 1e3:.3f} "
            f"({'bytes' if b_ms >= o_ms else 'operations'}), plain "
            f"{t['plain'][0] * 1e3:.2f}, sdpa {t['sdpa'][0] * 1e3:.2f}; "
            f"host-clock us per call: kernel {t['kernel'][1] * 1e3:.2f}, "
            f"plain {t['plain'][1] * 1e3:.2f}, sdpa "
            f"{t['sdpa'][1] * 1e3:.2f}; kernel vs sdpa max abs err {e:.3e} "
            f"[{card}]")

    # the serving run's launch mix: each request runs one prefill per layer
    # and one decode per layer at t = PROMPT .. PROMPT + GEN - 2, so every
    # shape below stands for N_REQ * n_layers launches
    mix = [shapes["prefill"]] + [(*dec, dict(q_start=t, kv_len=t + 1))
                                 for t in range(PROMPT, PROMPT + GEN - 1)]
    t = {i: time_replay(mix, fn, reps=3)[0] for i, fn in impls.items()}
    bounds = [fa_bound(*a) for a in mix]
    bound_ms = sum(max(b) for b in bounds) / len(mix)
    by = "bytes" if sum(b for b, _ in bounds) >= sum(o for _, o in bounds) \
        else "operations"
    say(f"timing: flash_attention over the serving run's launch mix "
        f"({len(mix)} shapes, {N_REQ * cfg.n_layers} launches each): device "
        f"us per launch: kernel {t['kernel'] * 1e3:.2f}, bound "
        f"{bound_ms * 1e3:.3f} ({by}), plain {t['plain'] * 1e3:.2f}, sdpa "
        f"{t['sdpa'] * 1e3:.2f} [{card}]")
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces=REPLACES["flash_attention"],
        launches=launches["flash_attention"],
        max_abs_err=err["flash_attention"], ms=t["kernel"],
        plain_ms=t["plain"], bound_ms=bound_ms, bound_by=by,
        library_ms=t["sdpa"])


def main() -> int:
    csrc = SRC / "repro_torch" / "csrc"
    if not all((csrc / f).is_file() for f in ("arena.cu",
                                              "flash_attention.cu")):
        say("FAIL: src/repro_torch not found beside chip_smoke.py; run it "
            "from the root of a checkout")
        return 2
    sys.path.insert(0, str(SRC))
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this check needs a "
            "CUDA card")
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK

    def timed_build(mod):
        t0 = time.perf_counter()
        return mod.build(), time.perf_counter() - t0

    with ThreadPoolExecutor(2) as ex:      # one nvcc per source, together
        builds = [ex.submit(timed_build, mod) for mod in (K, FK)]
        for fut in builds:
            lib, sec = fut.result()
            say(f"build: {lib.relative_to(ROOT)} in {sec:.1f} s")
    K._library()
    FK._library()
    say(f"card: {card}")

    rng = np.random.default_rng(SEED)
    err = {k: 0.0 for k in REPLACES}
    phase_kernels(dev, rng, err)
    phase_flash(dev, err)
    plans, inputs, launches, _ = phase_main(rng)
    model, params, plan, reqs, serve_launches, spans = phase_serve(dev)
    rows = phase_timing(plans, inputs, launches, err, card)
    rows.append(phase_serve_timing(model, params, plan, reqs, spans,
                                   serve_launches, err, card, dev))

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
