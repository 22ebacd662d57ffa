#!/usr/bin/env python3
"""Where a full-width llama3.2-1b train step spends its time on one card.
Run from the root of a checkout (about two minutes):

    python3 tools/train_probe.py

The step is ``chip_smoke.py``'s (batch 8 x seq 256, bf16, AdamW, random
weights from a seed, the flash kernels forward and backward), in the
parts ``chip_smoke.step_parts`` times: the loss (forward), its gradient
(backward), the clip and the optimizer's update.  It prints:

  * each part's device time (CUDA events between the parts) beside its
    host issue time (the clock from the part's first op to its last op
    queued, with no wait): a part whose device time is close to its issue
    time is held back by the host; medians of 5 steps;
  * one traced step (``torch.profiler``): the torch ops by device time
    (self), the top 25 with their calls;
  * ms per whole step (host clock, ending in ``synchronize``, median of 5)
    with the loss cutting each stacked parameter into its layers once
    (``models/zoo.py:_Unstacked``, ``unbind``) and, in turns with it,
    indexing the stacked tensor per layer (each layer's gradient then has
    the stacked shape): unbind, index, index, unbind.

With the argument ``grads`` (half a minute) it prints instead the
readings behind ``chip_smoke.TRAIN_GRAD_RTOL``: ``chip_smoke.grad_compare``
(the full-width gradient through the kernels against the plain versions,
leaf by leaf and layer by layer, and the same with one KV head's dK
zeroed in the last layer) for three seeds of weights and batch.

Every line ends with the card's name and power limit.
"""

from __future__ import annotations

import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    import chip_smoke as CS
    import repro_torch.configs as configs
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import zoo
    from repro_torch.models.zoo import build_model

    with ThreadPoolExecutor(len(FK.SOURCES)) as ex:
        list(ex.map(FK.build, FK.SOURCES))
    dev = torch.device("cuda", torch.cuda.current_device())
    card = CS.card_line()
    cfg = configs.get("llama3.2-1b")
    model = build_model(cfg)
    if sys.argv[1:] == ["grads"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        for seed in (CS.SEED, CS.SEED + 1, CS.SEED + 2):
            params = model.init(
                torch.Generator(device=dev).manual_seed(seed), dev)
            pipe = DataPipeline(cfg=cfg, seq_len=CS.TRAIN_SEQ,
                                global_batch=CS.TRAIN_BATCH, seed=seed)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch_at(seed - CS.SEED).items()}
            print(f"train_probe: seed {seed}: "
                  f"{CS.grad_compare(model, params, batch)} [{card}]",
                  flush=True)
            del params
            torch.cuda.empty_cache()
        return 0
    opt = make_optimizer(cfg, lr=3e-4)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    state = {"params": params, "opt": opt.init(params)}
    pipe = DataPipeline(cfg=cfg, seq_len=CS.TRAIN_SEQ,
                        global_batch=CS.TRAIN_BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    step = make_train_step(model, opt, peak_lr=3e-4, warmup=10,
                           total_steps=100)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    runs = [CS.step_parts(model, opt, state, batch) for _ in range(5)]
    for p in CS.TRAIN_PARTS:
        d = statistics.median(r[p][0] for r in runs)
        h = statistics.median(r[p][1] for r in runs)
        print(f"train_probe: {p}: device (CUDA events) {d:.2f} ms, host "
              f"issue {h:.2f} ms, medians of 5 [{card}]", flush=True)

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CS.LEAD_SPINS):
            torch.cuda._sleep(CS.LEAD_CYCLES)
        torch.cuda.synchronize()
        CS.step_parts(model, opt, state, batch)
    self_dev = lambda e: getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    ops = sorted((e for e in prof.key_averages()
                  if e.key not in CS.TRAIN_PARTS), key=lambda e: -self_dev(e))
    for e in ops[:25]:
        print(f"train_probe: op {e.key[:70]}: {self_dev(e):.1f} us self "
              f"device, {e.count} calls [{card}]")

    def step_ms(reps=5):
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ts)

    unstacked = zoo._Unstacked
    times = {"unbind": [], "index": []}
    try:
        for variant in ("unbind", "index", "index", "unbind"):
            zoo._Unstacked = unstacked if variant == "unbind" else \
                (lambda t: t)
            step_ms(1)                              # warm
            times[variant].append(step_ms())
    finally:
        zoo._Unstacked = unstacked
    print(f"train_probe: ms per step (median of 5, in turns) with the "
          f"stacked leaves unbound once: {times['unbind']}; indexed per "
          f"layer: {times['index']} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
