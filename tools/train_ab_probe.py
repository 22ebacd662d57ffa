#!/usr/bin/env python3
"""The full-width llama3.2-1b train step of one checkout, for an A/B
between checkouts on one card.  Run from the root of a checkout:

    python3 tools/train_ab_probe.py ROOT REMAT

``ROOT`` is the checkout whose port and ``chip_smoke.py`` are imported (for
another commit: ``git archive <commit> | tar -x -C build/parent``);
``REMAT`` is ``default`` (the config as it stands; a checkout older than
the port's remat ignores the field) or ``none`` / ``block`` / ``dots``.
The step is ``chip_smoke.py``'s (batch 8 x seq 256, bf16, AdamW, weights
from seed 0, the flash kernels forward and backward): one warm-up step,
then 7 timed (host clock, each ending in ``synchronize``), then the parts
(``chip_smoke.step_parts``: device ms by CUDA events and host issue ms)
three times, their medians.  It prints one line ``AB {...}`` with the
card's name and power limit.  Compare two checkouts only within one call,
in turns: ``parent, change, change, parent``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__)
        return 2
    root, remat = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    import chip_smoke as CS
    import repro_torch.configs as configs
    from repro_torch.data import DataPipeline
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.zoo import build_model
    if not Path(CS.__file__).resolve().is_relative_to(root):
        print(f"FAIL: imported {CS.__file__}, not {root}'s")
        return 2

    with ThreadPoolExecutor(len(FK.SOURCES)) as ex:
        list(ex.map(FK.build, FK.SOURCES))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("llama3.2-1b")
    if remat != "default":
        cfg = dataclasses.replace(cfg, remat=remat)
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=3e-4)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    pipe = DataPipeline(cfg=cfg, seq_len=256, global_batch=8, seed=0)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    state = {"params": params, "opt": opt.init(params)}
    step = make_train_step(model, opt, impl="auto", peak_lr=3e-4, warmup=10,
                           total_steps=7)
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    ms = []
    for _ in range(7):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    parts = [CS.step_parts(model, opt, state, batch) for _ in range(3)]
    med = {k: [statistics.median(p[k][i] for p in parts) for i in (0, 1)]
           for k in parts[0]}
    print("AB", json.dumps(dict(
        root=str(root), remat=remat, ms_median=statistics.median(ms),
        ms_min=min(ms), ms=ms, parts=med, card=CS.card_line())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
