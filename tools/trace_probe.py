#!/usr/bin/env python3
"""How complete are ``torch.profiler``'s traces of a decode token?  For each
served model, on one CUDA card, trace ``DecodeServer.step`` several times
as it is, and several times led by a spin kernel (``torch.cuda._sleep``,
run to its end inside the trace and left out of the counts), and print the
device activities each trace holds and the kernels that the least complete
trace lacks.  Run from the root of a checkout:

    python3 tools/trace_probe.py [--root DIR] [--traces N]

``--root`` runs the port and ``chip_smoke.py`` of another checkout (for
example a ``git archive`` of the parent commit unpacked under ``build/``),
so two trees are compared in one call.  The models are served as
``chip_smoke.py`` serves them: full width, random weights from its seed,
the recurrent mixing leaves filled, one request of its prompt length in
flight.  One line per model and lead, with the card's name and power limit;
all of it as JSON in ``chiprun_out/trace_probe.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
LEADS = ("none", "spin")
SPIN_CYCLES, SPIN_KERNEL = 2_000_000, "spin_kernel"


def trace(work, lead: str) -> Counter:
    """Device activities of one trace of ``work()``, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if lead == "spin":
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        work()
        torch.cuda.synchronize()
    return Counter(e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and SPIN_KERNEL not in e.name)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="checkout whose port and chip_smoke.py are run")
    ap.add_argument("--traces", type=int, default=6,
                    help="traces of a decode token for each lead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as CS
    import repro_torch.configs as configs
    from repro_torch.launch import serve as S
    from repro_torch.models.zoo import build_model

    card = CS.card_line()
    dev = torch.device("cuda", 0)
    # every trace takes a step of the one request, after four warm steps
    if len(LEADS) * args.traces + 4 >= CS.GEN:
        ap.error(f"at most {(CS.GEN - 5) // len(LEADS)} traces a lead")
    out = {}
    for arch, spec in CS.SERVES.items():
        cfg = configs.get(arch)
        model = build_model(cfg)
        smax = spec["prompt"] + CS.GEN
        plan = S.plan_decode_arena(model, 1, smax)
        params = model.init(
            torch.Generator(device=dev).manual_seed(CS.SEED), dev)
        CS.live_leaves(cfg, params, dev)
        req = S.synth_requests(1, spec["prompt"], CS.GEN, cfg.vocab_size,
                               CS.SEED + 1)[0]
        server = S.DecodeServer(model, params,
                                S.make_pool(4 * plan["arena_bytes"]),
                                smax=smax)
        server.submit(S.Request(rid=0, prompt=req.prompt, max_new=CS.GEN))
        for _ in range(4):                 # admit + prefill, then warm
            server.step()
        seen = {lead: [] for lead in LEADS}
        for _ in range(args.traces):       # the leads in turns
            for lead in LEADS:
                seen[lead].append(trace(server.step, lead))
        traces = [t for ts in seen.values() for t in ts]
        most = max(traces, key=lambda t: sum(t.values()))
        least = min(traces, key=lambda t: sum(t.values()))
        out[arch] = dict(
            {lead: [sum(t.values()) for t in ts] for lead, ts in seen.items()},
            most=sum(most.values()),
            lacking={k: v for k, v in (most - least).items()})
        for lead in LEADS:
            print(f"probe: {root.name} {arch} decode token, lead {lead}: "
                  f"device activities {out[arch][lead]} [{card}]",
                  flush=True)
        print(f"probe: {root.name} {arch}: most {out[arch]['most']}; the "
              f"least complete trace lacks {out[arch]['lacking']}",
              flush=True)
        del server, params, model
        torch.cuda.empty_cache()
    dest = HERE / "chiprun_out" / "trace_probe.json"
    dest.parent.mkdir(exist_ok=True)
    runs = json.loads(dest.read_text()) if dest.is_file() else {}
    runs[str(root)] = dict(card=card, models=out)
    dest.write_text(json.dumps(runs, indent=1))
    print(f"probe: wrote {dest.relative_to(HERE)}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
