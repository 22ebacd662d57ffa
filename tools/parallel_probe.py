#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 14 (``parallel``) alone, on one NVIDIA GPU.

    python3 tools/parallel_probe.py

Builds the arena and flash-attention kernels (one ``nvcc`` each, all
started together), then runs ``chip_smoke.phase_parallel``: at world size 1
(NCCL over an in-process store, a 1 x 1 mesh) llama3.2-1b served and
trained under sharding rules against the unsharded path (bit-equal, equal
launches, peak memory, ms per token and per step), granite-moe-3b-a800m's
expert-parallel MoE against the scatter form, and ``compressed_psum``.
Prints the phase's record as JSON and the card's name and power limit;
exits non-zero on a failed check or without CUDA.  About a minute and a
half on one H100, the kernels' build included.
"""

from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: this probe needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK

    t0 = time.perf_counter()
    jobs = [K.build] + [(lambda n=n: FK.build(n)) for n in FK.SOURCES]
    with ThreadPoolExecutor(len(jobs)) as ex:
        for fut in [ex.submit(j) for j in jobs]:
            fut.result()
    K._library()
    for n in FK.SOURCES:
        FK._library(n)
    C.say(f"build: {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.card_line()
    rec = C.phase_parallel(torch.device("cuda", 0), card)
    print(json.dumps(rec))
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except C.SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
