#!/usr/bin/env python3
"""The compiled train step on one card: the optimizer kernels
(``csrc/adamw.cu``) and the train step captured in one CUDA graph.  Run
from the root of a checkout:

    python3 tools/optim_probe.py check      # the kernels' checks and times
    python3 tools/optim_probe.py captured   # llama3.2-1b captured vs eager
    python3 tools/optim_probe.py cli [ARCH ...]   # the CLI and its resume
    python3 tools/optim_probe.py step       # one eager llama step, timed

Several modes run in turn: ``check captured cli``.

``check`` builds ``csrc/adamw.cu`` and its two control libraries
(``chip_smoke.OPTIM_CONTROL_EDITS``) together, prints ``-Xptxas -v`` for
the kernels, and runs ``chip_smoke.check_optim_kernels``: both kernels
against their plain versions on the ragged set and at llama3.2-1b's
full-width leaves, the controls, and their times beside their bounds, the
plain versions and the timing references.

``captured`` runs ``chip_smoke.captured_train_compare``: 4 captured steps
of llama3.2-1b at published width against 4 eager steps, bit-equal, with
ms a step, the idle share and the allocator's peaks.

``cli`` runs ``chip_smoke.cli_run_and_replay`` for each family that trains
(or the ARCHs given) at its chip_smoke settings: the CLI on the captured
step and its bit-equal resume from a checkpoint.

``step`` runs ``chip_smoke.time_train_step`` on one eager llama3.2-1b
step: ms, idle share, the parts (forward, backward, clip, optimizer) and
the peak.

Every line ends with the card's name and power limit.  JSON of the
records goes to ``chiprun_out/optim_probe.json``.
"""

from __future__ import annotations

import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def families() -> dict:
    """Each family that trains: its arch -> its chip_smoke CLI settings."""
    fams = [cs.LLAMA_CLI, cs.GRIFFIN_TRAIN, cs.RWKV_TRAIN,
            *cs.DECODER_TRAINS, *cs.LAST_TRAINS]
    return {f["arch"]: f for f in fams}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 2
    modes = argv or ["check"]
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    from repro_torch.kernels import _build
    from repro_torch.kernels.optim import kernel as OK
    t0 = time.perf_counter()
    jobs = [OK.build] + [(lambda n=n: cs.build_optim_control(n))
                         for n in cs.OPTIM_CONTROL_EDITS]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(lambda f: f(), jobs))
    cs.say(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f}"
           f" s")
    for ln in _build.ptxas_report(libs[0]):
        cs.say(f"build: ptxas adamw: {ln}")
    OK._library()
    controls = (cs.optim_control_fns(libs[2])[0],
                cs.optim_control_fns(libs[1])[1])
    out, failed = {}, []
    i = 0
    while i < len(modes):
        mode = modes[i]
        i += 1
        args = []
        while i < len(modes) and modes[i] not in ("check", "captured", "cli",
                                                  "step"):
            args.append(modes[i])
            i += 1
        t1 = time.perf_counter()
        try:
            run_mode(mode, args, out, dev, card, controls)
        except Exception:            # the next mode runs all the same
            import traceback
            failed.append(mode)
            cs.say(f"FAIL: {mode}: {traceback.format_exc()}")
        cs.say(f"{mode}: {time.perf_counter() - t1:.1f} s [{card}]")
    dst = ROOT / "chiprun_out" / "optim_probe.json"
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(json.dumps(out, indent=1, default=str))
    return 1 if failed else 0


def run_mode(mode, args, out, dev, card, controls) -> None:
    import torch
    if mode == "check":
        out["check"] = cs.check_optim_kernels(dev, card, controls)
    elif mode == "captured":
        out["captured"] = cs.captured_train_compare(dev, card)
    elif mode == "cli":
        fams = families()
        for arch in args or list(fams):
            out.setdefault("cli", {})[arch] = cs.family_cli(fams[arch], dev,
                                                            card)
    elif mode == "step":
        import repro_torch.configs as configs
        from repro_torch.data import DataPipeline
        from repro_torch.launch.steps import make_optimizer
        from repro_torch.models.zoo import build_model
        cfg = configs.get("llama3.2-1b")
        model = build_model(cfg)
        opt = make_optimizer(cfg, lr=3e-4)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            dev)
        state = {"params": params, "opt": opt.init(params)}
        pipe = DataPipeline(cfg=cfg, seq_len=cs.TRAIN_SEQ,
                            global_batch=cs.TRAIN_BATCH, seed=0)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(0).items()}
        out["step"] = cs.time_train_step(model, opt, state, batch, card)
        del state, params
        torch.cuda.empty_cache()
    else:
        raise SystemExit(f"unknown mode {mode!r}")


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except cs.SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
