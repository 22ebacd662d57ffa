#!/usr/bin/env python3
"""The host cost of ``chip_smoke.py``'s fleet phase: its nine runs (the
fault-free one and ``FLEET_FAULT_SEEDS`` faulted ones, ``chip_smoke.
fleet_runs``) at other arrival counts and on other pools.  Run from the root
of a checkout:

    python3 tools/fleet_host_probe.py N[:POOL] [N[:POOL] ...]

``N`` arrivals of the phase's ``OpenLoopLoadGen``; ``POOL`` is
``processes`` (the phase's, the default), ``threads`` (all runs in this
process) or ``alone`` (the fault-free run by itself, in this process).  It
touches no card.  Each case prints one line ``FLEET {...}``: the wall
seconds of the case, each run's seconds, the fault-free run's ticks and the
tokens served, and the card line (the machine the host belongs to).
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    import chip_smoke as cs
    from repro_torch.runtime.loadgen import OpenLoopLoadGen

    card = cs.card_line()
    smax = cs.SERVES["llama3.2-1b"]["prompt"] + cs.GEN
    buckets = (smax, 2 * smax, 8 * smax)
    for case in sys.argv[1:]:
        n, _, pool = case.partition(":")
        pool = pool or "processes"
        arrivals = OpenLoopLoadGen(seed=cs.SEED, rate=2.0, prompt_mean=1024,
                                   gen_mean=32, latency_frac=0.25).arrivals(
                                       int(n))
        t0 = time.perf_counter()
        if pool == "alone":
            runs = [cs.fleet_run(None, arrivals, buckets)]
        else:
            runs = cs.fleet_runs(arrivals, buckets, pool=pool)
        wall = time.perf_counter() - t0
        m = runs[0][1]
        print("FLEET " + json.dumps(dict(
            arrivals=int(n), pool=pool, wall_s=wall,
            run_s=[r[-1] for r in runs], ticks=m["ticks"],
            tokens=m["tokens"], card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
