#!/usr/bin/env python3
"""Which kernels a ``torch.profiler`` trace loses.  Run from the root of a
checkout on the card (half a minute):

    python3 tools/trace_lead_probe.py [TRACES]

Each of ``TRACES`` traces (default 300) holds 4 short spin kernels
(``torch.cuda._sleep``, 250,000 cycles each) as its lead, then 22 passes of
rwkv6-7b's three served decode-state copies (two of 262,144 B and one of
33,554,432 B through ``arena_write``: 66 launches), then one long spin
(4,000,000 cycles) as its tail; the spins tell lead from tail by their
time.  It prints each trace that lacks a kernel, and at the end one line
``TRACE {(copies, lead spins, tail spins): traces}`` with the card's name
and power limit.  ``chip_smoke.py:device_profile`` leads every trace with
``LEAD_SPINS`` spins from what this shows.
"""

from __future__ import annotations

import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as CS
    from repro_torch.kernels.arena import kernel as K

    n_traces = int(sys.argv[1]) if len(sys.argv) > 1 else 300
    K.build()
    K._library()
    dev = torch.device("cuda", 0)
    sizes = (262144, 262144, 33554432)
    offs = (0, 262144, 524288)
    arena = torch.zeros(sum(sizes), dtype=torch.uint8, device=dev)
    xs = [torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev)
          for n in sizes]
    hist = collections.Counter()
    for i in range(n_traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(250_000)
            torch.cuda.synchronize()
            for _ in range(22):
                for x, o in zip(xs, offs):
                    K.arena_write_cuda(arena, x, o)
            torch.cuda._sleep(4_000_000)
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        copies = sum(1 for e in evs if "arena_write_kernel" in e.name)
        spins = [e.time_range.elapsed_us() for e in evs
                 if "spin_kernel" in e.name]
        # a 250,000-cycle spin runs ~0.13 ms, the tail ~2 ms
        key = (copies, sum(t < 1000 for t in spins),
               sum(t >= 1000 for t in spins))
        hist[key] += 1
        if key != (66, 4, 1):
            print("trace", i, key, flush=True)
    print("TRACE", json.dumps({str(k): v for k, v in hist.items()}),
          CS.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
