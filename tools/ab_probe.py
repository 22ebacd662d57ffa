#!/usr/bin/env python3
"""Two end-to-end numbers of one checkout, on one CUDA card, for comparing
two trees in one call: the device busy time of a fused ``darts_net_x6``
execute (in all, of its ``chain_write`` kernels, and by kernel name), and
a ``recurrentgemma-2b``
prefill of 2560 tokens (host ms per request, device busy time, and its
RG-LRU kernels' share).  Run from the root of a checkout:

    python3 tools/ab_probe.py [--root DIR] [--reps N]

``--root`` runs the port and ``chip_smoke.py`` of another checkout (for
example a ``git archive`` of the parent commit unpacked under ``build/``);
run the two trees in turns in one call (parent, change, change, parent),
since two calls may land on two cards.  The network and the model are
made as ``chip_smoke.py`` makes them: the planner's arena, inputs and
random weights from its seed, Griffin's recurrent mixing leaves filled.
Device times are read from ``torch.profiler`` traces (the median of
``--reps``), host times from the clock around a synchronised prefill.
One JSON line, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose port and chip_smoke.py are run")
    ap.add_argument("--reps", type=int, default=5,
                    help="traces (and prefills) a number is the median of")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as CS
    import repro_torch as rt
    import repro_torch.configs as configs
    from repro_torch.graphs import FULL_NETWORKS
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.zoo import build_model

    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"root": str(root), "card": CS.card_line()}

    def kernel_us(by_name, part):
        return sum(t for k, (t, _) in by_name.items() if part in k)

    # a fused darts_net_x6 execute, inputs on the card
    p = rt.plan(FULL_NETWORKS["darts_net_x6"](), rt.PlanConfig())
    rng = np.random.default_rng(CS.SEED)
    inputs = {k: torch.from_numpy(v).to(dev)
              for k, v in CS.seeded_inputs(p.graph, rng).items()}

    def execute():
        rt.execute(p.graph, inputs, p.arena, order=p.order, fuse=True)

    for _ in range(3):
        execute()
    busy, chain, names = [], [], {}
    for _ in range(args.reps):
        us, _, by = CS.device_profile(lambda: [execute() for _ in range(3)])
        busy.append(us / 3)
        chain.append(kernel_us(by, "chain_write_kernel") / 3)
        for k, (t, n) in by.items():
            names.setdefault(k[:70], []).append((t / 3, n / 3))
    out["darts_fused_busy_us"] = statistics.median(busy)
    out["darts_fused_chain_us"] = statistics.median(chain)
    out["darts_fused_busy_all"] = busy
    # device us and launches per execute by kernel name, medians
    out["darts_fused_by_kernel"] = {
        k: [statistics.median(t for t, _ in v),
            statistics.median(n for _, n in v)] for k, v in names.items()}

    # a recurrentgemma-2b prefill of one request
    cfg = configs.get("recurrentgemma-2b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(CS.SEED), dev)
    CS.live_leaves(cfg, params, dev)
    prompt_len = CS.SERVES[cfg.name]["prompt"]
    prompt = S.synth_requests(1, prompt_len, CS.GEN, cfg.vocab_size,
                              CS.SEED + 1)[0].prompt
    prefill = make_prefill_step(model)
    batch = {"tokens": torch.as_tensor(prompt, dtype=torch.long,
                                       device=dev)[None]}
    smax = prompt_len + CS.GEN
    ms, busy, rec = [], [], []
    for i in range(args.reps + 1):
        cache = model.init_cache(1, smax, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, cache, batch)
        torch.cuda.synchronize()
        if i:                                    # the first warms up
            ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(args.reps):
        cache = model.init_cache(1, smax, dev)
        us, _, by = CS.device_profile(lambda: prefill(params, cache, batch))
        busy.append(us)
        rec.append(kernel_us(by, "rglru"))
    out["griffin_prefill_ms"] = statistics.median(ms)
    out["griffin_prefill_ms_all"] = ms
    out["griffin_prefill_busy_us"] = statistics.median(busy)
    out["griffin_prefill_rglru_us"] = statistics.median(rec)
    print(json.dumps(out), flush=True)
    print(out["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
