#!/usr/bin/env python3
"""rwkv6-7b's training on one card: the WKV-6 backward kernel and the
gradient at published width.  Run from the root of a checkout:

    python3 tools/rwkv6_train_probe.py check          # a minute
    python3 tools/rwkv6_train_probe.py time           # half a minute
    python3 tools/rwkv6_train_probe.py grads [SEED ...]
    python3 tools/rwkv6_train_probe.py noise [LAYERS]
    python3 tools/rwkv6_train_probe.py step [LAYERS]  # a minute
    python3 tools/rwkv6_train_probe.py train          # two minutes
    python3 tools/rwkv6_train_probe.py compare FILE   # half a minute
    python3 tools/rwkv6_train_probe.py dryrun         # half a minute

Several modes run in turn: ``check time grads``.

``check`` builds ``csrc/wkv6.cu``, ``csrc/wkv6_backward.cu`` and the WKV-6
control (a copy of ``csrc/wkv6_backward.cu`` with
``chip_smoke.WKV6_CONTROL_EDIT``), prints ``-Xptxas -v`` for the backward
kernels, and runs ``chip_smoke.check_wkv6_backward`` (the backward kernel
against ``wkv6_backward_torch``, two runs bit-equal, the control above
the limit).

``time`` runs ``chip_smoke.time_rwkv_kernels``: the backward at rwkv6-7b's
training shape beside its bound and plain version.

``grads`` reads, for seeds 0, 1 and 2 (or those given), the gradient of
rwkv6-7b's loss at published width and ``chip_smoke.RWKV_LAYERS`` deep
through the kernels against the plain versions'
(``chip_smoke.family_grad_compare``: the worst relative L2 error over all
leaves and the time mix's, stacked ones by layer, and the two controls'),
without its limit: the readings ``RWKV_GRAD_RTOL`` is set from.

``noise`` holds seed 0's gradient at LAYERS (default ``RWKV_LAYERS``)
against the f32 plain gradient: through the kernels in bf16 and in f32,
and through the plain versions in bf16.

``step`` times one train step through the kernels at published width and
LAYERS deep (default ``RWKV_LAYERS``; ``chip_smoke.time_train_step``: ms a
step, tokens/s, idle share, the allocator's peak) and prints the card's
memory beside the peak: how deep a step fits.

``train`` runs ``chip_smoke.family_train`` on ``RWKV_TRAIN``: the
gradient check, one step against the plain step with its launches, the
step's time, the CLI's run at cut depth and its bit-equal resume.

``dryrun`` runs ``chip_smoke.dryrun_rwkv6``: a train step at published
width and ``RWKV_CLI_LAYERS`` deep counted on real and on fake tensors.

``compare FILE`` builds FILE (another version of
``csrc/wkv6_backward.cu``, e.g. a ``git archive`` of another commit's
under ``build/``, whatever its layout's constants), reads each output of
the two kernels against each other at rwkv6-7b's training shape in units
of the card's limit (``chip_smoke.wkv6_bwd_reading``; sums in another
order differ within it) and times both in turns.

Every line ends with the card's name and power limit.  JSON of the
readings goes to ``chiprun_out/rwkv6_train_probe.json``.
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

MODES = ("check", "time", "grads", "noise", "step", "train", "compare",
         "dryrun")


def grads(dev, card, CS, control, seeds) -> dict:
    out = {}
    for seed in seeds:
        model, params, batch = CS.family_inputs(CS.RWKV_TRAIN, dev, seed)
        rec = CS.family_grad_compare(CS.RWKV_TRAIN, model, params, batch,
                                     control)
        out[str(seed)] = rec
        CS.say(f"grads: seed {seed}, {rec['layers']} layers: " + "; ".join(
            f"{name}: " + ", ".join(f"{g} {r:.4e} at {at}"
                                    for g, (r, at) in groups.items())
            for name, groups in rec["readings"].items())
            + f"; loss {rec['loss_kernels']} vs {rec['loss_plain']} "
              f"[{card}]")
        del model, params, batch
        torch.cuda.empty_cache()
    return out


def noise(dev, card, CS, layers) -> dict:
    """Seed 0's gradient at ``layers`` against the f32 plain one (the
    parameters cast to f32, impl="torch"): through the kernels in bf16,
    through the plain versions in bf16, and through the kernels in f32
    (each ``worst_grad_err``, stacked leaves by layer).  The kernels'
    bf16 reading beside the plain versions' says whether the bf16
    reading is the kernels' or bf16's; the f32 one holds the kernels at
    published width."""
    from repro_torch.models.params import tree_map
    model, params, batch = CS.family_inputs(CS.RWKV_TRAIN, dev, CS.SEED,
                                           layers)
    paths = CS.leaf_paths(params)
    L = model.cfg.n_layers
    p32 = tree_map(lambda t: t.detach().float(), params)
    _, want = CS.loss_grads(model, p32, batch, "torch")
    out = {}
    for name, tree, impl in (("kernels_f32", p32, "auto"),
                             ("kernels_bf16", params, "auto"),
                             ("plain_bf16", params, "torch")):
        _, got = CS.loss_grads(model, tree, batch, impl)
        out[name] = CS.worst_grad_err(got, want, paths, L)
        del got
        torch.cuda.empty_cache()
    CS.say(f"noise: {CS.RWKV} at {layers} layers, seed {CS.SEED}, against "
           f"the f32 plain gradient: " + "; ".join(
               f"{k} {r:.4e} at {at}" for k, (r, at) in out.items())
           + f" [{card}]")
    return out


def step(dev, card, CS, layers) -> dict:
    from repro_torch.launch.steps import make_optimizer
    model, params, batch = CS.family_inputs(CS.RWKV_TRAIN, dev, CS.SEED,
                                           layers)
    opt = make_optimizer(model.cfg, lr=3e-4)
    state = {"params": params, "opt": opt.init(params)}
    torch.cuda.reset_peak_memory_stats()
    rec = CS.time_train_step(model, opt, state, batch, card)
    total = torch.cuda.get_device_properties(dev).total_memory
    reserved = torch.cuda.max_memory_reserved()
    free, _ = torch.cuda.mem_get_info()
    CS.say(f"step: {CS.RWKV} at {layers} layers: peak allocated "
           f"{rec['peak_allocated']} B, peak reserved {reserved} B of "
           f"{total} B ({(total - rec['peak_allocated']) / 1e9:.2f} GB "
           f"above the allocated peak; free now {free} B) [{card}]")
    del state, params, opt, model
    torch.cuda.empty_cache()
    return dict(rec, layers=layers, total_memory=total,
                peak_reserved=reserved)


def other_backward(lib_path):
    """The bf16 backward of another build of ``csrc/wkv6_backward.cu``,
    called as ``wkv6_backward_cuda`` is, whatever constants it was built
    with: its checkpoint scratch is allocated for a checkpoint every 8
    steps, the finest any of its layouts takes."""
    import ctypes
    lib = ctypes.CDLL(str(lib_path))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn = lib.repro_wkv6_backward_bf16
    fn.argtypes = [vp] * 16 + [ll] * 4 + [vp]
    fn.restype = ctypes.c_int

    def run(r, k, v, w, u, s0, do, dsT=None):
        B, T, H, N = r.shape
        outs = [torch.empty_like(r) for _ in range(4)]
        du = torch.empty_like(u)
        ds0 = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
        ckpt = torch.empty((B, H, -(-T // 8), N, N), dtype=torch.float32,
                           device=r.device)
        du_part = torch.empty((B, H, N), dtype=torch.float32,
                              device=r.device)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        err = fn(*(ptr(t) for t in (r, k, v, w, u, s0, do, dsT, *outs, du,
                                    ds0, ckpt, du_part)), B, T, H, N,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the other backward's launch failed ({err})")
        return (*outs, du, None if s0 is None else ds0)

    return run


def compare(dev, card, CS, path) -> dict:
    """Another build of the backward's source (``path``, e.g. an earlier
    version unpacked under ``build/``) against this checkout's kernel at
    rwkv6-7b's training shape: each output's reading against the other's
    in units of the limit, then us a call of each in a replayed graph, in
    turns (this, other, other, this)."""
    import statistics

    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6 import kernel as WK
    other = other_backward(_build.build(Path(path), "wkv6_backward_other"))
    B, T = CS.WKV_BWD_CASES[0]
    r, k, v, w, u, _, do, _ = CS.wkv6_bwd_inputs(dev, B, T, torch.bfloat16,
                                                 False, CS.SEED + 3)
    H, N = CS.WKV_BWD_HEADS["H"], CS.WKV_BWD_HEADS["N"]
    args = (r, k, v, w, u, None, do, torch.zeros(B, H, N, N, device=dev))
    fns = {"this": lambda: WK.wkv6_backward_cuda(*args),
           "other": lambda: other(*args)}
    names = ("dr", "dk", "dv", "dw", "du")
    readings = {name: CS.wkv6_bwd_reading(a, b) for name, a, b in
                zip(names, fns["this"](), fns["other"]())}
    turns = {"this": [], "other": []}
    for name in ("this", "other", "other", "this"):
        turns[name].append(CS.graph_ms(fns[name], (), dev, 10) * 1e3)
    out = {name: statistics.mean(t) for name, t in turns.items()}
    CS.say(f"compare: wkv6_backward at (B {B}, T {T}, H {H}, N {N}, bf16), "
           f"us a call in a replayed graph: this checkout "
           f"{turns['this']}, {path} {turns['other']}; each output against "
           f"the other's, in units of the limit: "
           + ", ".join(f"{n} {x:.3f}" for n, x in readings.items())
           + f" [{card}]")
    return dict(turns_us=turns, mean_us=out, readings=readings, other=path)


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6 import kernel as WK
    args = sys.argv[1:] or ["check"]
    jobs = [WK.build, WK.build_backward, CS.build_wkv6_control]
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = [f.result() for f in [ex.submit(j) for j in jobs]]
    card = CS.card_line()
    for lib in libs[:2]:
        for ln in _build.ptxas_report(lib):
            CS.say(f"build: ptxas {lib.stem[3:]}: {ln}")
    WK._library()
    WK._backward_library()
    control = CS.wkv6_control_fn(libs[2])
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
        numbers = []
        while i < len(args) and args[i] not in MODES:
            numbers.append(args[i])
            i += 1
        if mode != "compare":
            numbers = [int(x) for x in numbers]
        t0 = time.perf_counter()
        if mode == "check":
            rec["check"] = CS.check_wkv6_backward(dev, control)
        elif mode == "time":
            rec["time"] = CS.time_rwkv_kernels(dev, card)
        elif mode == "grads":
            rec["grads"] = grads(dev, card, CS, control, numbers or [0, 1, 2])
        elif mode == "noise":
            rec["noise"] = noise(dev, card, CS,
                                 numbers[0] if numbers else CS.RWKV_LAYERS)
        elif mode == "step":
            rec["step"] = step(dev, card, CS,
                               numbers[0] if numbers else CS.RWKV_LAYERS)
        elif mode == "compare":
            rec["compare"] = compare(dev, card, CS, numbers[0])
        elif mode == "dryrun":
            rec["dryrun"] = CS.dryrun_rwkv6(dev, card)
        elif mode == "train":
            rec["train"] = CS.family_train(CS.RWKV_TRAIN, dev, card, control)
        else:
            raise SystemExit(f"unknown mode {mode!r}; modes: {MODES}")
        CS.say(f"{mode}: {time.perf_counter() - t0:.1f} s [{card}]")
        torch.cuda.empty_cache()
        (out / "rwkv6_train_probe.json").write_text(
            json.dumps(rec, indent=1, default=str))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
