#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout.  It needs one CUDA card, ``nvcc`` and
nothing of JAX.  Phases, each fatal (an exception or a failed check exits
non-zero):

1. build   -- compile ``src/repro_torch/csrc/arena.cu`` (nvcc, sm_90a)
              and print the build seconds, the card's name and power limit;
2. kernels -- hold each arena kernel against its plain PyTorch version on
              the card: awkward offsets and lengths (0, 1, 3, 4097 and
              150,528, the largest tensor of the DARTS cell), f32 and u8;
              write/read/accum and the exact chain ops bit-equal, the
              transcendental chain ops allclose; n == 0 launches nothing;
3. main    -- plan every paper graph and full network with SERENITY and
              execute it in one arena on the card, slice-per-node and fused:
              realized == planned bytes, slice path bit-equal to
              ``run_reference`` on the card, fused path bit-equal where every
              fused chain is exact (else allclose), the planner's known
              integers, a uint8 pack/unpack round trip, and each of the four
              kernels launched > 0 times over the run;
4. timing  -- microseconds per ``execute`` of the two full networks, and per
              kernel at the launches the main path made: the kernel, its
              bound (bytes moved / 3.35 TB/s), its plain version and the one
              torch call that computes the same (a yardstick, never called
              by the port).

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
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
SIZES = (0, 1, 3, 4097, 150528)    # 150,528 f32 = 28x28x48x4 B: DARTS fmap
CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-6  # expf/tanhf vs torch's eager kernels
SEED = 0

# file:line of the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "write": "src/repro/kernels/arena/kernel.py:65",
    "read": "src/repro/kernels/arena/kernel.py:89",
    "accum": "src/repro/kernels/arena/kernel.py:77",
    "chain_write": "src/repro/kernels/arena/kernel.py:100",
}


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
# Phase 3: the main path
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
# Phase 4: timings
# ---------------------------------------------------------------------------


def device_us(work) -> float:
    """Microseconds the card spent running kernels (and copies) during
    ``work()``, summed from a ``torch.profiler`` trace of its activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    check(us > 0, "the profiler saw no device activity")
    return us


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


def main() -> int:
    if not (SRC / "repro_torch" / "csrc" / "arena.cu").is_file():
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
    t0 = time.perf_counter()
    lib = K.build()
    K._library()
    say(f"build: {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"card: {card}")

    rng = np.random.default_rng(SEED)
    err = {k: 0.0 for k in REPLACES}
    phase_kernels(dev, rng, err)
    plans, inputs, launches, _ = phase_main(rng)
    rows = phase_timing(plans, inputs, launches, err, card)

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
