#!/usr/bin/env python3
"""The compiled train step on one card: the optimizer kernels
(``csrc/adamw.cu``, ``csrc/adafactor.cu``) and the train step captured in
one CUDA graph.  Run from the root of a checkout:

    python3 tools/optim_probe.py check      # the AdamW kernels, times
    python3 tools/optim_probe.py adafactor  # the Adafactor kernels, times
    python3 tools/optim_probe.py rsqrt      # rsqrtf against torch.rsqrt
    python3 tools/optim_probe.py captured   # llama3.2-1b captured vs eager
    python3 tools/optim_probe.py adacaptured  # deepseek-v3-671b's too
    python3 tools/optim_probe.py adarules   # deepseek's step under rules
    python3 tools/optim_probe.py cli [ARCH ...]   # the CLI and its resume
    python3 tools/optim_probe.py step       # one eager llama step, timed

Several modes run in turn: ``check adafactor captured cli``.

Every call builds ``csrc/adamw.cu``, ``csrc/adafactor.cu`` and their
control libraries (``chip_smoke.OPTIM_CONTROL_EDITS``,
``chip_smoke.ADAFACTOR_CONTROL_EDITS``) together and prints ``-Xptxas -v``
for the kernels.  ``check`` runs ``chip_smoke.check_optim_kernels``: both
AdamW kernels against their plain versions on the ragged set and at
llama3.2-1b's full-width leaves, the controls, and their times beside
their bounds, the plain versions and the timing references.

``adafactor`` runs ``chip_smoke.check_adafactor_kernels``: the three
Adafactor kernels against the plain version (within the limits, with the
readings), their order emulated on the card (bit-equal), two runs
(bit-equal) and the two controls, on the ragged set and at
deepseek-v3-671b's 31 full-width leaves; then their times there beside
their bounds, the plain update, the norm and ``torch.optim.Adafactor``.
``adafactor SEED ...`` prints the readings of other seeds instead (the
limits come from them).

``rsqrt`` builds a two-line kernel and counts the f32 inputs (2^24 random
positive bit patterns and the powers of two) where ``rsqrtf`` and IEEE
``__frsqrt_rn`` differ from ``torch.rsqrt`` on the card: the Adafactor
kernels use the one that does not.

``adacaptured`` runs ``chip_smoke.captured_train_compare`` for
deepseek-v3-671b at its CLI's depth (``DEEPSEEK_CLI_LAYERS``): 3 captured
steps against 3 eager ones, bit-equal in the metrics and every leaf of
parameters and Adafactor state, launches a replay ``train_launches``.

``adarules`` runs phase 14's Adafactor step (``chip_smoke.par_training``
for deepseek-v3-671b at its CLI's depth, a 1 x 1 mesh): 2 steps under
rules, whose moments take the split route (``adafactor_sums`` twice a
step), against 2 unsharded steps (the fused route), bit-equal.

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
    jobs = [OK.build, OK.build_adafactor] + [
        (lambda n=n: cs.build_optim_control(n))
        for n in cs.OPTIM_CONTROL_EDITS] + [
        (lambda n=n: cs.build_adafactor_control(n))
        for n in cs.ADAFACTOR_CONTROL_EDITS]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(lambda f: f(), jobs))
    cs.say(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f}"
           f" s")
    for lib in libs[:2]:
        for ln in _build.ptxas_report(lib):
            cs.say(f"build: ptxas {lib.stem[3:]}: {ln}")
    OK._library()
    OK._adafactor_library()
    by_stem = {lib.stem[3:]: lib for lib in libs}
    controls = {
        "adamw": (cs.optim_control_fns(by_stem["adamw_control_skip"])[0],
                  cs.optim_control_fns(by_stem["adamw_control_wd"])[1]),
        "adafactor": {n: OK.bind_adafactor(by_stem[n])
                      for n in cs.ADAFACTOR_CONTROL_EDITS}}
    out, failed = {}, []
    i = 0
    while i < len(modes):
        mode = modes[i]
        i += 1
        args = []
        while i < len(modes) and modes[i] not in MODES:
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


MODES = ("check", "adafactor", "rsqrt", "captured", "adacaptured",
         "adarules", "cli", "step")

RSQRT_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void rsqrt_both(const float* x, float* a, float* b, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) { a[i] = rsqrtf(x[i]); b[i] = __frsqrt_rn(x[i]); }
}
extern "C" int rsqrt_both_run(const void* x, void* a, void* b, long long n,
                              void* stream) {
  rsqrt_both<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)a, (float*)b, n);
  return (int)cudaGetLastError();
}
"""


def rsqrt_probe(dev, card) -> dict:
    """``rsqrtf`` and ``__frsqrt_rn`` against ``torch.rsqrt`` on the card:
    2^24 random positive finite f32 bit patterns and every power of two."""
    import ctypes

    import torch

    from repro_torch.kernels import _build
    src = ROOT / "build" / "optim_probe" / "rsqrt_probe.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(RSQRT_SOURCE)
    lib = ctypes.CDLL(str(_build.build(src, "rsqrt_probe")))
    vp = ctypes.c_void_p
    lib.rsqrt_both_run.argtypes = [vp, vp, vp, ctypes.c_longlong, vp]
    lib.rsqrt_both_run.restype = ctypes.c_int
    gen = torch.Generator(device=dev).manual_seed(0)
    bits = torch.randint(1, 0x7F800000, (1 << 24,), generator=gen,
                         device=dev, dtype=torch.int32)
    pows = torch.arange(-149, 128, device=dev, dtype=torch.float32)
    x = torch.cat([bits.view(torch.float32), torch.exp2(pows)])
    a, b = torch.empty_like(x), torch.empty_like(x)
    err = lib.rsqrt_both_run(x.data_ptr(), a.data_ptr(), b.data_ptr(),
                             x.numel(), torch.cuda.current_stream().cuda_stream)
    cs.check(err == 0, f"the rsqrt probe's launch failed ({err})")
    want = torch.rsqrt(x)
    out = {"inputs": x.numel(),
           "rsqrtf_differs": int((a != want).sum()),
           "frsqrt_rn_differs": int((b != want).sum())}
    cs.say(f"rsqrt: of {out['inputs']} positive f32 inputs, rsqrtf differs "
           f"from torch.rsqrt in {out['rsqrtf_differs']}, __frsqrt_rn in "
           f"{out['frsqrt_rn_differs']} [{card}]")
    return out


def readings_by_seed(dev, seeds, controls) -> dict:
    """``chip_smoke.adafactor_check_set``'s readings (its checks too) on the
    ragged set and at deepseek-v3-671b's leaves for each seed (the state
    from ``seed``, the gradients from the next ones): the limits are set
    from these."""
    import torch

    from repro_torch.optim import adafactor
    opt = adafactor(lr=3e-4)
    ragged = list(cs.ADAFACTOR_RAGGED) * 2
    dts = ([torch.float32] * len(cs.ADAFACTOR_RAGGED)
           + [torch.bfloat16] * len(cs.ADAFACTOR_RAGGED))
    shapes = cs.deepseek_leaf_shapes()
    out = {}
    for seed in seeds:
        out[seed] = {
            "ragged": cs.adafactor_check_set(
                f"the ragged set, seed {seed}", ragged, dts, dev, opt,
                controls, seed, 2,
                offsets=[i % 2 for i in range(len(ragged))])[0],
            "deepseek": cs.adafactor_check_set(
                f"deepseek-v3-671b's leaves, seed {seed}", shapes,
                [torch.bfloat16] * len(shapes), dev, opt, controls, seed,
                cs.ADAFACTOR_UPDATES, emulate=False)[0]}
        torch.cuda.empty_cache()
    return out


def run_mode(mode, args, out, dev, card, controls) -> None:
    import torch
    if mode == "check":
        out["check"] = cs.check_optim_kernels(dev, card, controls["adamw"])
    elif mode == "adafactor" and not args:
        out["adafactor"] = cs.check_adafactor_kernels(
            dev, card, controls["adafactor"])
    elif mode == "adafactor":           # the readings of other seeds
        out["adafactor_seeds"] = readings_by_seed(
            dev, [int(a) for a in args], controls["adafactor"])
    elif mode == "rsqrt":
        out["rsqrt"] = rsqrt_probe(dev, card)
    elif mode == "captured":
        out["captured"] = cs.captured_train_compare(dev, card)
    elif mode == "adacaptured":
        out["adacaptured"] = cs.captured_train_compare(
            dev, card, arch=cs.DEEPSEEK, layers=cs.DEEPSEEK_CLI_LAYERS,
            steps=cs.ADAFACTOR_CAPTURED_STEPS)
    elif mode == "adarules":
        from repro_torch.launch.mesh import (
            init_single_process,
            make_host_mesh,
            rules_for_mesh,
        )
        init_single_process(dev)
        try:
            mesh = make_host_mesh(1, 1, device=dev)
            out["adarules"] = cs.par_training(
                dev, card, rules_for_mesh(mesh), mesh, arch=cs.DEEPSEEK,
                layers=cs.DEEPSEEK_CLI_LAYERS)
        finally:
            torch.distributed.destroy_process_group()
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
