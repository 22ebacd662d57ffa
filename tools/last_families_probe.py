#!/usr/bin/env python3
"""The last two families' training on one card: the flash backward
non-causal with Sq != Skv (seamless-m4t-medium) and at (192, 128)
(deepseek-v3-671b's MLA), and the gradients at published width.  Run from
the root of a checkout:

    python3 tools/last_families_probe.py check           # a minute
    python3 tools/last_families_probe.py time            # half a minute
    python3 tools/last_families_probe.py step ARCH:LAYERS [ARCH:LAYERS ...]
    python3 tools/last_families_probe.py grads [SEED ...]
    python3 tools/last_families_probe.py noise [ARCH ...]
    python3 tools/last_families_probe.py train           # the whole block

Several modes run in turn: ``check step deepseek-v3-671b:4 grads``.

``check`` builds the flash kernels (``kernels/flash_attention/kernel.py:
SOURCES``), prints ``-Xptxas -v`` for both backward libraries, and runs
``chip_smoke.check_flash_backward_new_forms`` (both backward kernels
non-causal and at (192, 128) against ``flash_attention_backward_torch``,
two tensor-core runs bit-equal, each case's control above the limit,
``FlashAttentionFn`` against autograd).

``time`` runs ``chip_smoke.time_new_forms``: the new forms' backward at
the training shapes beside its bound, its plain version and SDPA's
backward.

``step ARCH:LAYERS ...`` is ``tools/decoder_train_probe.py``'s: train
steps through the kernels at published width, LAYERS deep, under the
config's optimizer (``chip_smoke.time_train_step``: ms a step, the
allocator's peak) for each pair in turn, the card's memory beside the
peak; a pair that runs out of memory is printed as such.

``grads`` reads, for seeds 0, 1 and 2 (or those given), the gradient of
each of ``chip_smoke.LAST_TRAINS`` at its depth through the kernels
against the plain versions' (``chip_smoke.family_grad_compare`` on
``chip_smoke.grad_batch``: the worst relative L2 error over all leaves
and the attention's, stacked ones by layer, and its controls'), without
its limit: the readings ``LAST_GRAD_RTOL`` is set from.

``noise`` holds each family's gradient (seed 0, or of the ARCHs given)
against the f32 plain gradient (the parameters cast to f32,
impl="torch"): through the kernels in f32 (the CUDA-core backward) and in
bf16 (the tensor-core one), and through the plain versions in bf16, each
over all leaves and the attention's.  The bf16 plain versions' reading
beside the kernels' says whether a bf16 reading is the kernels' or
bf16's; the f32 one holds the kernels.

``train`` runs ``chip_smoke.last_families_train``: the block as the smoke
script runs it.

Every line ends with the card's name and power limit.  JSON of the
readings goes to ``chiprun_out/last_families_probe.json``.
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

from decoder_train_probe import step  # noqa: E402

MODES = ("check", "time", "step", "grads", "noise", "train")


def grads(dev, card, CS, seeds) -> dict:
    out = {}
    for fam in CS.LAST_TRAINS:
        for seed in seeds:
            model, params, batch = CS.family_inputs(fam, dev, seed)
            batch = CS.grad_batch(fam, batch, dev, seed)
            rec = CS.family_grad_compare(fam, model, params, batch, None)
            out[f"{fam['arch']} {seed}"] = rec
            CS.say(f"grads: {fam['arch']}, seed {seed}, {rec['layers']} "
                   f"layers: " + "; ".join(
                       f"{name}: " + ", ".join(
                           f"{g} {r:.4e} at {at}"
                           for g, (r, at) in groups.items())
                       for name, groups in rec["readings"].items())
                   + f"; loss {rec['loss_kernels']} vs {rec['loss_plain']}"
                   + f" [{card}]")
            del model, params, batch
            torch.cuda.empty_cache()
    return out


def noise(dev, card, CS, archs) -> dict:
    from repro_torch.models.params import tree_map
    out = {}
    for fam in CS.LAST_TRAINS:
        if archs and fam["arch"] not in archs:
            continue
        model, params, batch = CS.family_inputs(fam, dev, CS.SEED)
        batch = CS.grad_batch(fam, batch, dev, CS.SEED)
        paths = CS.leaf_paths(params)
        L = model.cfg.n_layers
        keep = [fam["group"][1] in p for p in paths]
        p32 = tree_map(lambda t: t.detach().float(), params)
        _, want = CS.loss_grads(model, p32, batch, "torch")
        rec = {}
        for name, tree, impl in (("kernels_f32", p32, "auto"),
                                 ("kernels_bf16", params, "auto"),
                                 ("plain_bf16", params, "torch")):
            _, got = CS.loss_grads(model, tree, batch, impl)
            sel = [i for i, k in enumerate(keep) if k]
            rec[name] = dict(
                all=CS.worst_grad_err(got, want, paths, L),
                attn=CS.worst_grad_err([got[i] for i in sel],
                                       [want[i] for i in sel],
                                       [paths[i] for i in sel], L))
            del got
            torch.cuda.empty_cache()
        out[fam["arch"]] = rec
        CS.say(f"noise: {fam['arch']} at {L} layers, seed {CS.SEED}, "
               f"against the f32 plain gradient: " + "; ".join(
                   f"{k} all {r['all'][0]:.4e} at {r['all'][1]}, attention "
                   f"{r['attn'][0]:.4e} at {r['attn'][1]}"
                   for k, r in rec.items()) + f" [{card}]")
        del model, params, batch, p32, want
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
            rec["check"] = CS.check_flash_backward_new_forms(dev)
        elif mode == "time":
            rec["time"] = CS.time_new_forms(dev, card)
        elif mode == "step":
            rec.setdefault("step", {}).update(step(dev, card, CS, words))
        elif mode == "grads":
            rec["grads"] = grads(dev, card, CS,
                                 [int(x) for x in words] or [0, 1, 2])
        elif mode == "noise":
            rec["noise"] = noise(dev, card, CS, words)
        elif mode == "train":
            rec["train"] = CS.last_families_train(dev, card)
        else:
            raise SystemExit(f"unknown mode {mode!r}; modes: {MODES}")
        CS.say(f"{mode}: {time.perf_counter() - t0:.1f} s [{card}]")
        torch.cuda.empty_cache()
        (out / "last_families_probe.json").write_text(
            json.dumps(rec, indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
