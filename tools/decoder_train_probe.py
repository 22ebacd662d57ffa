#!/usr/bin/env python3
"""The dense and MoE decoders' training on one card: the flash backward at
(128, 128) and the gradients at published width.  Run from the root of a
checkout:

    python3 tools/decoder_train_probe.py check           # a minute
    python3 tools/decoder_train_probe.py time            # half a minute
    python3 tools/decoder_train_probe.py step ARCH:LAYERS [ARCH:LAYERS ...]
    python3 tools/decoder_train_probe.py grads [SEED ...]
    python3 tools/decoder_train_probe.py noise [LAYERS ...]
    python3 tools/decoder_train_probe.py train           # the whole block

Several modes run in turn: ``check step starcoder2-7b:16 grads``.

``check`` builds the flash kernels (``kernels/flash_attention/kernel.py:
SOURCES``), prints ``-Xptxas -v`` for both backward libraries, and runs
``chip_smoke.check_flash_backward_d128`` (both backward kernels at (128,
128) against ``flash_attention_backward_torch``, two tensor-core runs
bit-equal, KV head 0's dK zeroed above the limit, ``FlashAttentionFn``
against autograd) and ``chip_smoke.check_flash_backward`` (llama's heads).

``time`` runs ``chip_smoke.time_d128_kernels``: the (128, 128) backward at
starcoder2-7b's, granite-20b's and chameleon-34b's heads beside its bound,
its plain version and SDPA's backward.

``step ARCH:LAYERS ...`` runs one train step through the kernels at
published width, LAYERS deep (``chip_smoke.time_train_step``: ms a
step, the allocator's peak), for each pair in turn, and
prints the card's memory beside the peak: how deep a step fits.  A pair
that runs out of memory is printed as such and the next one runs.

``grads`` reads, for seeds 0, 1 and 2 (or those given), the gradient of
each of ``chip_smoke.DECODER_TRAINS`` and ``DECODER_GRADS`` at its depth
through the kernels against the plain versions'
(``chip_smoke.family_grad_compare``: the worst relative L2 error over all
leaves and the attention's, stacked ones by layer, its control's; the
MoE's under forced expert ids, with its flips), without its limit: the
readings ``DECODER_GRAD_RTOL`` is set from.

``noise`` holds granite-moe-3b-a800m's gradient (seed 0, at each of
LAYERS, default all 32) against the f32 plain gradient (the parameters
cast to f32, impl="torch"): through the kernels in f32 and in bf16, and
through the plain versions in bf16, every run forced to the f32 plain
run's expert ids (gates its own), its flips printed.  The bf16 plain
versions' reading beside the kernels' says whether a bf16 reading is the
kernels' or bf16's; the f32 one holds the kernels.

``train`` runs ``chip_smoke.decoders_train``: the block as the smoke
script runs it.

Every line ends with the card's name and power limit.  JSON of the
readings goes to ``chiprun_out/decoder_train_probe.json``.
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

MODES = ("check", "time", "step", "grads", "noise", "train")


def grads(dev, card, CS, seeds) -> dict:
    out = {}
    for fam in CS.DECODER_TRAINS + CS.DECODER_GRADS:
        for seed in seeds:
            model, params, batch = CS.family_inputs(fam, dev, seed)
            rec = CS.family_grad_compare(fam, model, params, batch, None)
            out[f"{fam['arch']} {seed}"] = rec
            routing = rec["routing"]
            CS.say(f"grads: {fam['arch']}, seed {seed}, {rec['layers']} "
                   f"layers: " + "; ".join(
                       f"{name}: " + ", ".join(
                           f"{g} {r:.4e} at {at}"
                           for g, (r, at) in groups.items())
                       for name, groups in rec["readings"].items())
                   + f"; loss {rec['loss_kernels']} vs {rec['loss_plain']}"
                   + ("" if routing is None else f"; routing {routing}")
                   + f" [{card}]")
            del model, params, batch
            torch.cuda.empty_cache()
    return out


def noise(dev, card, CS, layers) -> dict:
    from repro_torch.models.params import tree_map
    out = {}
    for n in layers:
        model, params, batch = CS.family_inputs(CS.MOE_TRAIN, dev, CS.SEED,
                                               n)
        paths = CS.leaf_paths(params)
        L = model.cfg.n_layers
        p32 = tree_map(lambda t: t.detach().float(), params)
        with CS.RouteLog() as ref:
            _, want = CS.loss_grads(model, p32, batch, "torch")
        rec = {}
        for name, tree, impl in (("kernels_f32", p32, "auto"),
                                 ("kernels_bf16", params, "auto"),
                                 ("plain_bf16", params, "torch")):
            with CS.RouteLog(ref.routes, own_gates=True) as log:
                _, got = CS.loss_grads(model, tree, batch, impl)
            rec[name] = dict(zip(("worst", "at"), CS.worst_grad_err(
                got, want, paths, L)), flips=log.summary()["flips"])
            del got
            torch.cuda.empty_cache()
        out[str(n)] = rec
        CS.say(f"noise: {CS.MOE_ARCH} at {n} layers, seed {CS.SEED}, against "
               f"the f32 plain gradient, every run forced to its expert "
               f"ids: " + "; ".join(
                   f"{k} {r['worst']:.4e} at {r['at']} ({r['flips']} flips)"
                   for k, r in rec.items()) + f" [{card}]")
        del model, params, batch, p32, want
        torch.cuda.empty_cache()
    return out


def step(dev, card, CS, pairs) -> dict:
    from repro_torch.launch.steps import make_optimizer
    out = {}
    total = torch.cuda.get_device_properties(dev).total_memory
    for pair in pairs:
        arch, layers = pair.split(":")
        fam = dict(arch=arch, layers=int(layers))
        try:
            model, params, batch = CS.family_inputs(fam, dev, CS.SEED)
            opt = make_optimizer(model.cfg, lr=3e-4)
            state = {"params": params, "opt": opt.init(params)}
            torch.cuda.reset_peak_memory_stats()
            rec = CS.time_train_step(model, opt, state, batch, card)
            out[pair] = dict(rec, layers=int(layers), total_memory=total)
            CS.say(f"step: {arch} at {layers} layers: peak allocated "
                   f"{rec['peak_allocated']} B, peak reserved "
                   f"{rec['peak_reserved']} B of {total} B "
                   f"({(total - rec['peak_reserved']) / 1e9:.2f} GB above "
                   f"the reserved peak) [{card}]")
        except torch.OutOfMemoryError as e:
            out[pair] = dict(out_of_memory=str(e).splitlines()[0])
            CS.say(f"step: {arch} at {layers} layers: out of memory "
                   f"({str(e).splitlines()[0]}) [{card}]")
        model = params = batch = opt = state = None
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    args = sys.argv[1:] or ["check"]
    with ThreadPoolExecutor(len(FK.SOURCES)) as ex:
        libs = list(ex.map(FK.build, FK.SOURCES))
    card = CS.card_line()
    for lib in libs:
        if "backward" in lib.stem:
            for ln in _build.ptxas_report(lib):
                CS.say(f"build: ptxas {lib.stem[3:]}: {ln}")
    for n in FK.SOURCES:
        FK._library(n)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"card": card}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    i = 0
    while i < len(args):
        mode = args[i]
        i += 1
        words = []
        while i < len(args) and args[i] not in MODES:
            words.append(args[i])
            i += 1
        t0 = time.perf_counter()
        if mode == "check":
            rec["check"] = dict(d128=CS.check_flash_backward_d128(dev),
                                d64=CS.check_flash_backward(dev))
        elif mode == "time":
            rec["time"] = CS.time_d128_kernels(dev, card)
        elif mode == "step":
            rec.setdefault("step", {}).update(step(dev, card, CS, words))
        elif mode == "grads":
            rec["grads"] = grads(dev, card, CS,
                                 [int(x) for x in words] or [0, 1, 2])
        elif mode == "noise":
            rec["noise"] = noise(dev, card, CS,
                                 [int(x) for x in words] or [None])
        elif mode == "train":
            rec["train"] = CS.decoders_train(dev, card)
        else:
            raise SystemExit(f"unknown mode {mode!r}; modes: {MODES}")
        CS.say(f"{mode}: {time.perf_counter() - t0:.1f} s [{card}]")
        torch.cuda.empty_cache()
        (out / "decoder_train_probe.json").write_text(
            json.dumps(rec, indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
