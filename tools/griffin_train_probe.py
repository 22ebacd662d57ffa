#!/usr/bin/env python3
"""recurrentgemma-2b's training on one card: the new backward kernels and
the full-width gradient.  Run from the root of a checkout:

    python3 tools/griffin_train_probe.py check      # a minute
    python3 tools/griffin_train_probe.py grads      # two minutes
    python3 tools/griffin_train_probe.py time       # a minute
    python3 tools/griffin_train_probe.py train      # three minutes
    python3 tools/griffin_train_probe.py compare FILE   # half a minute

``check`` builds ``csrc/rglru.cu`` (with the RG-LRU backward kernel), both
flash backward kernels and the forward ones, and the RG-LRU control (a copy
of ``csrc/rglru.cu`` with ``chip_smoke.RGLRU_CONTROL_EDIT``), prints
``-Xptxas -v`` for the backward kernels, and runs ``chip_smoke.py``'s
kernel checks of phase 9's Griffin part: ``check_rglru_backward`` (the
RG-LRU backward against ``rglru_backward_torch``) and
``check_flash_backward_griffin`` (both flash backward kernels at (256,
256) with windows against ``flash_attention_backward_torch``, the window
one key too wide as a control, ``FlashAttentionFn`` with a window).

``grads`` reads, for seeds 0, 1 and 2 (or those given), the full-width
gradient of recurrentgemma-2b's loss through the kernels against the
plain versions' (``chip_smoke.family_grad_compare``'s readings: the worst
relative L2 error over all leaves, the recurrent blocks' and the rest,
stacked ones by layer, and the three controls'), without its limits: the
readings ``GRIFFIN_GRAD_RTOL`` and ``GRIFFIN_REC_GRAD_RTOL`` are set
from.

``time`` runs ``chip_smoke.time_griffin_kernels``: the RG-LRU backward and
both flash backward kernels at Griffin's training shapes beside their
bounds, plain versions and SDPA's backward.

``train`` runs ``chip_smoke.family_train`` on ``GRIFFIN_TRAIN``: the
gradient check, one step against the plain step with its launches, the
step's time, the CLI's run at cut depth and its bit-equal resume.

``compare FILE`` builds FILE (another version of ``csrc/rglru.cu``, e.g. a
``git archive`` of another commit's under ``build/``), holds its backward
bit-equal to this checkout's at Griffin's training shape (bf16) and times
both in turns (this, other, other, this) in replayed graphs.

Every line ends with the card's name and power limit.  JSON of the
readings goes to ``chiprun_out/griffin_train_probe_<mode>.json``.
"""

from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def grads(dev, card, CS, seeds) -> dict:
    control = CS.rglru_control_fn(CS.build_rglru_control())
    out = {}
    for seed in seeds:
        model, params, batch = CS.family_inputs(CS.GRIFFIN_TRAIN, dev, seed)
        rec = CS.family_grad_compare(CS.GRIFFIN_TRAIN, model, params, batch,
                                     control)
        out[str(seed)] = rec
        CS.say(f"grads: seed {seed}: " + "; ".join(
            f"{name}: " + ", ".join(f"{g} {r:.4e} at {at}"
                                    for g, (r, at) in groups.items())
            for name, groups in rec["readings"].items()) + f" [{card}]")
        del model, params, batch
        torch.cuda.empty_cache()
    return out


def compare(dev, card, CS, path) -> dict:
    """Another build of ``csrc/rglru.cu`` (``path``) against this
    checkout's backward kernel at Griffin's training shape: bit-equal
    outputs, then us a call of each in a replayed graph, in turns."""
    import statistics

    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import kernel as RK
    other = CS.rglru_control_fn(_build.build(Path(path), "rglru_other"))
    B, T = CS.RG_BWD_CASES[0]
    args = CS.rglru_bwd_inputs(dev, B, T, torch.bfloat16, False,
                               CS.SEED + 3)
    fns = {"this": lambda: RK.rglru_backward_cuda(*args),
           "other": lambda: other(*args)}
    equal = all(torch.equal(a, b) for a, b in zip(fns["this"](),
                                                  fns["other"]())
                if a is not None)
    turns = {"this": [], "other": []}
    for name in ("this", "other", "other", "this"):
        turns[name].append(CS.graph_ms(fns[name], (), dev, 10) * 1e3)
    out = {name: statistics.mean(x) for name, x in turns.items()}
    CS.say(f"compare: rglru_backward at (B {B}, T {T}, D {CS.RG_BWD_D}, "
           f"bf16), us a call in a replayed graph: this checkout "
           f"{turns['this']}, {path} {turns['other']}; outputs bit-equal "
           f"{equal} [{card}]")
    return dict(turns_us=turns, mean_us=out, bit_equal=equal, other=path)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    jobs = [RK.build, CS.build_rglru_control] + [
        (lambda n=n: FK.build(n)) for n in FK.SOURCES]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = [f.result() for f in [ex.submit(j) for j in jobs]]
    card = CS.card_line()
    for lib in libs:
        if lib.stem in ("librglru", "libflash_backward",
                        "libflash_backward_sm90"):
            for ln in _build.ptxas_report(lib):
                CS.say(f"build: ptxas {lib.stem[3:]}: {ln}")
    RK._library()
    for n in FK.SOURCES:
        FK._library(n)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"card": card}
    if mode == "check":
        t0 = time.perf_counter()
        rec["rglru_backward"] = CS.check_rglru_backward(
            dev, CS.rglru_control_fn(libs[1]))
        t1 = time.perf_counter()
        rec["flash_backward"] = CS.check_flash_backward_griffin(dev)
        CS.say(f"check: {t1 - t0:.1f} s and "
               f"{time.perf_counter() - t1:.1f} s [{card}]")
    elif mode == "grads":
        seeds = [int(a) for a in sys.argv[2:]] or [0, 1, 2]
        rec["grads"] = grads(dev, card, CS, seeds)
    elif mode == "time":
        rec["time"] = CS.time_griffin_kernels(dev, card)
    elif mode == "train":
        rec["train"] = CS.family_train(CS.GRIFFIN_TRAIN, dev, card,
                                       CS.rglru_control_fn(libs[1]))
    elif mode == "compare":
        rec["compare"] = compare(dev, card, CS, sys.argv[2])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"griffin_train_probe_{mode}.json").write_text(
        json.dumps(rec, indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
