#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 15 (``dryrun``) alone, on one NVIDIA GPU.

    python3 tools/dryrun_probe.py

Builds the flash-attention kernels (one ``nvcc`` each, all started
together), then runs ``chip_smoke.phase_dryrun``: llama3.2-1b's train step
and an eager decode step under the dry-run's counting mode on real and on
fake CUDA tensors (equal counts, nothing allocated or launched by the fake
run), the modelled compute time beside the measured step, and the CLI
(``python -m repro_torch.launch.dryrun``) for llama3.2-1b ``train_4k`` and
deepseek-v3-671b ``decode_32k`` on the card's routes over a fake 256-rank
group.  Prints the phase's record as JSON and the card's name and power
limit; exits non-zero on a failed check or without CUDA.  Records and logs
go to ``chiprun_out/dryrun/``.
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
    from repro_torch.kernels.flash_attention import kernel as FK

    t0 = time.perf_counter()
    jobs = [(lambda n=n: FK.build(n)) for n in FK.SOURCES]
    with ThreadPoolExecutor(len(jobs)) as ex:
        for fut in [ex.submit(j) for j in jobs]:
            fut.result()
    for n in FK.SOURCES:
        FK._library(n)
    C.say(f"build: {time.perf_counter() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = C.card_line()
    rec = C.phase_dryrun(torch.device("cuda", 0), card)
    print(json.dumps(rec))
    print(card)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except C.SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
