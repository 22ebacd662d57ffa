#!/usr/bin/env python3
"""A quick look at the CUDA-graph paths on one card: captured against
eager, for the full networks' ``execute`` and the served models' decode
step.  Run from the root of a checkout (a minute and a half):

    python3 tools/capture_probe.py

For ``darts_net_x6`` and ``randwire_net_32x8``, slice and fused: whether
``execute(..., jit=True)`` (the warm-up call, a replay, a replay with other
inputs) is bit-equal to the eager runs, the capture's launches per replay
beside the eager run's, the arena kernels in three traces of a replay, the
device activities of a replay and of an eager run, and host-clock
microseconds per execute, eager and captured (median and min of 10).

For ``llama3.2-1b``, ``recurrentgemma-2b`` and ``rwkv6-7b`` at full width
(random weights from a seed, the recurrent mixing leaves filled as
``chip_smoke.py`` fills them): after a prefill, six positions decoded by
the captured step (``make_captured_decode_step``) and by the eager
``decode_fn``, logits compared bit for bit; the launches per replay; the
device time and activities of a replay and of an eager step; host-clock
ms per step, eager and captured.  Every line ends with the card's name and
power limit.
"""

from __future__ import annotations

import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def host_times(fn, reps=10, scale=1e3):
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * scale)
    return statistics.median(ts), min(ts)


def executes(CS, dev, card, rng):
    import repro_torch as rt
    from repro_torch.graphs import FULL_NETWORKS
    from repro_torch.kernels.arena import kernel as K

    names = ("arena_write", "arena_read", "accum_kernel", "chain_write")
    for name in ("darts_net_x6", "randwire_net_32x8"):
        p = rt.plan(FULL_NETWORKS[name](), rt.PlanConfig())
        a, b = (CS.seeded_inputs(p.graph, rng) for _ in range(2))
        for fuse in (False, True):
            def run(x, **kw):
                return rt.execute(p.graph, x, p.arena, order=p.order,
                                  fuse=fuse, **kw)

            K.reset_launches()
            ea = run(a).outputs
            torch.cuda.synchronize()
            per = dict(K.LAUNCHES)
            eb = run(b).outputs
            r1 = run(a, jit=True).outputs
            r2 = run(a, jit=True).outputs
            r3 = run(b, jit=True).outputs
            ok = all(torch.equal(r1[k], ea[k]) and torch.equal(r2[k], ea[k])
                     and torch.equal(r3[k], eb[k]) for k in ea)
            prog = rt.compile_plan(p.graph, p.order, p.arena, fuse=fuse)
            call = prog._captures[None][0]
            traced = []
            for _ in range(3):
                _, n, by = CS.device_profile(lambda: run(a, jit=True))
                traced.append((n, sum(c for k, (_, c) in by.items()
                                      if any(x in k for x in names))))
            busy, n_eager, _ = CS.device_profile(lambda: run(a))
            eager_us = host_times(lambda: run(a), scale=1e6)
            jit_us = host_times(lambda: run(a, jit=True), scale=1e6)
            print(f"execute {name} {'fused' if fuse else 'slice'}: jit "
                  f"bit-equal {ok}; launches eager {per}, per replay "
                  f"{ {k: call.launches[k] for k in per} }; replay traces "
                  f"(activities, arena kernels) {traced}, eager "
                  f"{n_eager} activities, {busy:.1f} us busy; host us "
                  f"median/min eager {eager_us[0]:.1f}/{eager_us[1]:.1f}, "
                  f"captured {jit_us[0]:.1f}/{jit_us[1]:.1f} [{card}]",
                  flush=True)


def decodes(CS, dev, card, rng):
    import repro_torch.configs as configs
    from repro_torch.launch.steps import make_captured_decode_step
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.zoo import build_model

    for arch, P in (("llama3.2-1b", 1024), ("recurrentgemma-2b", 2560),
                    ("rwkv6-7b", 1024)):
        cfg = configs.get(arch)
        m = build_model(cfg)
        params = m.init(torch.Generator(device=dev).manual_seed(CS.SEED), dev)
        CS.live_leaves(cfg, params, dev)
        smax = P + 32
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, P)).to(
            dev)[None]
        cache = m.init_cache(1, smax, dev)
        logits, cache = m.prefill_fn(params, cache, {"tokens": prompt})
        step = make_captured_decode_step(m, params, smax=smax, device=dev)
        for d, s in zip(tree_leaves(step.cache), tree_leaves(cache)):
            d.copy_(s)
        tok, ok = int(logits.argmax(-1)[0]), True
        for t in range(P, P + 6):
            want, cache = m.decode_fn(
                params, cache, torch.tensor([[tok]], device=dev), t)
            ok &= torch.equal(step(tok, t), want)
            tok = int(want.argmax(-1)[0])

        def eager():
            m.decode_fn(params, cache, torch.tensor([[tok]], device=dev),
                        P + 6)

        rep = [CS.device_profile(lambda: step(tok, P + 6))[:2]
               for _ in range(2)]
        eag = CS.device_profile(eager)[:2]
        e_ms, c_ms = host_times(eager), host_times(lambda: step(tok, P + 6))
        print(f"decode {arch}: captured bit-equal to eager over 6 positions "
              f"{ok}; launches per replay "
              f"{ {k: v for k, v in step.call.launches.items() if v} }; "
              f"replay traces (busy us, activities) {rep}, eager {eag}; "
              f"host ms median/min eager {e_ms[0]:.3f}/{e_ms[1]:.3f}, "
              f"captured {c_ms[0]:.3f}/{c_ms[1]:.3f} [{card}]", flush=True)
        del params, cache, step, m
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: this probe needs a CUDA card")
        return 2
    import chip_smoke as CS
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rwkv6 import kernel as WK

    jobs = [K.build, WK.build, RK.build] + [
        (lambda n=n: FK.build(n)) for n in FK.SOURCES]
    with ThreadPoolExecutor(len(jobs)) as ex:
        for fut in [ex.submit(j) for j in jobs]:
            fut.result()
    dev = torch.device("cuda", torch.cuda.current_device())
    card = CS.card_line()
    rng = np.random.default_rng(CS.SEED)
    executes(CS, dev, card, rng)
    decodes(CS, dev, card, rng)
    return 0


if __name__ == "__main__":
    sys.exit(main())
