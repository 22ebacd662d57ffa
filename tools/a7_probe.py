#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone, in readings mode: the encoder-
decoder's and MLA's attention shapes, then ``seamless-m4t-medium`` and
``deepseek-v3-671b`` (depth cut to 4 layers) served on the card, with
every check's failure printed instead of raised.

    python3 tools/a7_probe.py [ARCH ...] [--strict] [--no-shapes]

It builds the flash and arena kernels (one ``nvcc`` each, together), runs
``chip_smoke.phase_flash_a7`` and ``time_a7_shapes`` (unless
``--no-shapes``), then for each ``ARCH`` (default: both) the serve, timing
and vmap phases and, where the model has one, the f32 check at its cut
depth.  A check that fails prints ``PROBE: check failed: ...`` and the run
goes on, so that one run gives every reading the limits are set from
(``--strict`` keeps the checks fatal, as in ``chip_smoke.py``).  The
readings go to ``chiprun_out/a7_probe.json``.  Needs one CUDA card and
``nvcc``; about three minutes.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("archs", nargs="*", default=list(cs.A7))
    ap.add_argument("--strict", action="store_true",
                    help="a failed check stops the run")
    ap.add_argument("--no-shapes", action="store_true",
                    help="skip the attention shapes' checks and times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 2
    failed = []
    if not args.strict:
        def check(cond, what):
            if not cond:
                failed.append(what)
                cs.say(f"PROBE: check failed: {what}")
        cs.check = check

    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(FK.SOURCES) + 1) as ex:
        for f in [ex.submit(K.build)] + [ex.submit(FK.build, n)
                                         for n in FK.SOURCES]:
            f.result()
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.say(f"probe: built in {time.perf_counter() - t0:.1f} s; card: {card}")
    out = {"card": card}
    if not args.no_shapes:
        err = {"flash_attention": 0.0}
        out["max_abs_err_by_route"] = cs.phase_flash_a7(dev, err)
        out["shapes"] = cs.time_a7_shapes(card, dev)
    for arch in args.archs:
        rec = out.setdefault(arch, {})
        ctx = cs.phase_serve(dev, arch)
        rec["logit_err"] = ctx["logit_err"]
        rec["routing"] = ctx["routing"]
        rec["launches"] = ctx["launches"]
        rec["decode"] = cs.phase_serve_timing(ctx, card, dev,
                                              packing=False)["decode"]
        rec["decode"].update(cs.decode_bound(ctx["model"].cfg, card,
                                             ctx["smax"]))
        rec["vmap"] = cs.phase_serve_vmap(ctx, card, dev)
        del ctx
        torch.cuda.empty_cache()
        if "f32_depth" in cs.A7[arch]:
            rec["f32_at_cut_depth"] = cs.check_cut_f32(arch, dev)
        cs.say(f"probe: {arch} done at {time.perf_counter() - t0:.1f} s")
    out["failed_checks"] = failed
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "a7_probe.json").write_text(
        json.dumps(out, indent=1, default=str))
    cs.say(f"probe: {len(failed)} failed checks; {time.perf_counter() - t0:.1f}"
           f" s [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
