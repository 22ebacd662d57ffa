#!/usr/bin/env python3
"""The two flash backward kernels on one card: checks and times.  Run from
the root of a checkout:

    python3 tools/flash_backward_probe.py check     # half a minute
    python3 tools/flash_backward_probe.py time      # a minute
    python3 tools/flash_backward_probe.py variants [NAME ...]   # a minute

``check`` builds ``csrc/flash_backward_sm90.cu`` (the tensor-core kernel)
and ``csrc/flash_backward.cu`` (the CUDA-core one), prints ``-Xptxas -v``
for both, and holds each against ``flash_attention_backward_torch`` at
``chip_smoke.BWD_CASES`` (llama3.2-1b's heads: H 32, KV 8, D 64) in bf16
(and the CUDA-core kernel in f32), under ``chip_smoke.bwd_tol``; it also
holds the tensor-core kernel against ``flash_backward_tiled_torch`` run on
the card with the kernel's bf16 rounding, against the CUDA-core kernel,
and against itself (two runs bit-equal).  Readings are in bf16 ulps of
each gradient's largest value.

``time`` times, at the train step's shape (B 8, S 256, bf16), the
CUDA-core kernel, the tensor-core kernel, the tensor-core kernel again and
the CUDA-core kernel again (in turns), then SDPA's backward (a yardstick)
and the plain version, each by ``chip_smoke.time_replay``; then one trace
of 10 calls of each kernel, with the device us of each of its kernels (the
breakdown: the tensor-core kernel's dQ and dK/dV launches).

``variants`` builds copies of ``csrc/flash_backward_sm90.cu`` with the
edits of ``VARIANTS`` (all, or those named) into
``build/flash_backward_variants/`` with the repository's nvcc flags (the
source itself is not changed), prints ptxas's report and advisories for
each, holds each against the plain version (4 bf16 ulps) and its own
second run (bit-equal) at the train step's shape, and times them there
by a trace of 20 calls, each kernel's launches apart: the repository's
kernel first and last, the variants in between.  The variants:

  stamps   the kernel with clock64() stamps of thread 0 of every block,
           summed by phase (dQ: start, issue copies, wait for tiles, the
           first sweep's product and softmax, the second sweep's S and dP
           products, P and dS, the dQ product, the barrier, the store;
           dK/dV likewise): cycles a block in each phase, over one call
  dq3      the dQ kernel with three ring stages and three blocks an SM
           (151 registers) instead of two stages and four (128)

Every line ends with the card's name and power limit.  JSON of the
readings goes to ``chiprun_out/flash_backward_probe.json``.
"""

from __future__ import annotations

import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of want's largest magnitude."""
    scale = float(want.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)
    return float((got.float() - want.float()).abs().max()) / ulp


def check(dev, card, CS, FK) -> dict:
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_backward_torch,
        flash_backward_tiled_torch,
    )
    out = {}
    for B, S in CS.BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = CS.attn_inputs(dev, B, S, dtype, CS.SEED + S)
            o = FK.flash_attention_cuda(q, k, v, causal=True, window=None,
                                        q_start=0, kv_len=S)
            want = flash_attention_backward_torch(q, k, v, o, do)
            kernels = {"simple": FK.flash_backward_simple_cuda}
            if dtype == torch.bfloat16:
                kernels["sm90"] = FK.flash_backward_sm90_cuda
            got = {}
            for name, fn in kernels.items():
                got[name] = fn(q, k, v, o, do)
                torch.cuda.synchronize()
                for gname, g, w in zip(("dq", "dk", "dv"), got[name], want):
                    tol = CS.bwd_tol(w, dtype)
                    e = float((g.float() - w.float()).abs().max())
                    key = f"{name} {dtype} ({B}, {S}) {gname}"
                    out[key] = dict(err=e, tol=tol, ulps=ulps(g, w))
                    CS.check(e <= tol, f"{key}: max abs err {e} > {tol}")
            if dtype != torch.bfloat16:
                continue
            emu = flash_backward_tiled_torch(q, k, v, o, do, round_bf16=True)
            again = FK.flash_backward_sm90_cuda(q, k, v, o, do)
            torch.cuda.synchronize()
            for i, gname in enumerate(("dq", "dk", "dv")):
                key = f"sm90 ({B}, {S}) {gname}"
                out[key + " vs tiled emulation"] = ulps(got["sm90"][i],
                                                        emu[i])
                out[key + " vs simple"] = ulps(got["sm90"][i],
                                               got["simple"][i])
                CS.check(torch.equal(got["sm90"][i], again[i]),
                         f"{key}: two runs differ")
    for key, r in out.items():
        CS.say(f"check: {key}: {r} [{card}]")
    CS.say(f"check: every case within bwd_tol; the tensor-core kernel's "
           f"two runs bit-equal [{card}]")
    return out


def timing(dev, card, CS, FK) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_backward_torch,
    )
    B, S = CS.TRAIN_BATCH, CS.TRAIN_SEQ
    q, k, v, do = CS.attn_inputs(dev, B, S, torch.bfloat16, CS.SEED + 3)
    o = FK.flash_attention_cuda(q, k, v, causal=True, window=None,
                                q_start=0, kv_len=S)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                        enable_gqa=True)
    dos = do.transpose(1, 2)
    fns = {
        "simple": lambda: FK.flash_backward_simple_cuda(q, k, v, o, do),
        "sm90": lambda: FK.flash_backward_sm90_cuda(q, k, v, o, do),
        "sdpa": lambda: torch.autograd.grad(so, (qs, ks, vs), dos,
                                            retain_graph=True),
        "plain": lambda: flash_attention_backward_torch(q, k, v, o, do),
    }
    runs = []
    for name in ("simple", "sm90", "sm90", "simple", "sdpa", "plain"):
        ms, call_ms = CS.time_replay([()], fns[name], reps=20)
        runs.append(dict(name=name, us=ms * 1e3, call_us=call_ms * 1e3))
        CS.say(f"time: {name}: device {ms * 1e3:.2f} us per call, "
               f"{call_ms * 1e3:.2f} us with the host's issue [{card}]")
    nbytes, nops = CS.bwd_bound(q, k, v)
    bound = dict(bytes_us=nbytes * 1e3, operations_us=nops * 1e3)
    CS.say(f"time: bound {max(bound.values()):.3f} us ({bound}) [{card}]")
    split = {}
    for name in ("sm90", "simple"):
        busy, n_act, by_name = CS.device_profile(
            lambda: [fns[name]() for _ in range(10)])
        split[name] = {k: dict(us_per_call=t / 10, launches=c)
                       for k, (t, c) in by_name.items()}
        for kname, r in split[name].items():
            CS.say(f"time: {name} breakdown: {kname[:70]}: "
                   f"{r['us_per_call']:.2f} us a call ({r['launches']} "
                   f"launches in 10 calls) [{card}]")
    return dict(runs=runs, bound=bound, breakdown=split)


def stamps(lib, fn, CS, card) -> dict:
    """A variant with clock stamps (``repro_flash_backward_sm90_stamps``:
    32 u64 sums of clock64() deltas of thread 0 of every block, the dQ
    kernel's phases in slots 0-9 and its blocks in 15, the dK/dV kernel's
    in 16-23 and 31): cycles a block in each phase, over one call."""
    import ctypes
    buf = (ctypes.c_ulonglong * 32)()
    lib.repro_flash_backward_sm90_stamps(buf)        # set to 0
    fn()
    torch.cuda.synchronize()
    lib.repro_flash_backward_sm90_stamps(buf)
    names = (["start", "issue copies", "wait for tiles", "S product (1)",
              "softmax (1)", "S, dP products (2)", "P, dS (2)",
              "dQ product (2)", "barrier", "store"],
             ["start", "issue copies", "wait for tiles", "S, dP products",
              "P, dS", "dV, dK products", "barrier", "store"])
    out = {}
    for k, kname in enumerate(("dq", "dkdv")):
        blocks = max(1, buf[16 * k + 15])
        out[kname] = {n: buf[16 * k + i] / blocks
                      for i, n in enumerate(names[k])}
        CS.say(f"stamps {kname} ({blocks} blocks), cycles a block: "
               + ", ".join(f"{n} {c:.0f}" for n, c in out[kname].items())
               + f"; all {sum(out[kname].values()):.0f} [{card}]")
    return out


def _stamp(k: int, i: int) -> str:
    return f"BWD_STAMP({k}, {i});\n"


# (old, new) edits of csrc/flash_backward_sm90.cu, each applied to the
# first occurrence of old
STAMPS = [
    ("#include <cuda_bf16.h>",
     "#include <cuda_bf16.h>\n__device__ unsigned long long g_stamps[32];\n"
     "#define BWD_STAMP(k, i) if (threadIdx.x == 0) { const long long t_ = "
     "clock64(); atomicAdd(&g_stamps[16 * (k) + (i)], (unsigned long long)"
     "(t_ - t_prev_)); t_prev_ = t_; }\n"),
    ("const long long W = p.window;\n  const int tid = threadIdx.x, "
     "warp = tid >> 5, lane = tid & 31;\n",
     "const long long W = p.window;\n  const int tid = threadIdx.x, "
     "warp = tid >> 5, lane = tid & 31;\n  long long t_prev_ = clock64();\n"),
    ("  float dq[32];\n", "  " + _stamp(0, 0) + "  float dq[32];\n"),
    ("< 2 * n) load_step(j + kStages - 1, ahead);\n    cp_async_commit();\n",
     "< 2 * n) load_step(j + kStages - 1, ahead);\n    cp_async_commit();\n"
     "    " + _stamp(0, 1)),
    ("    const uint32_t ks = sK + stage",
     "    " + _stamp(0, 2) + "    const uint32_t ks = sK + stage"),
    ("      fence_regs(s);\n      float mx[2]",
     "      fence_regs(s);\n      " + _stamp(0, 3) + "      float mx[2]"),
    ("    } else {\n      // sweep 2",
     "      " + _stamp(0, 4) + "    } else {\n      // sweep 2"),
    ("      two_products_ss<kD>(s, sQ, ks, dp, sdO, vs);\n",
     "      two_products_ss<kD>(s, sQ, ks, dp, sdO, vs);\n      "
     + _stamp(0, 5)),
    ("      to_frags(dp, a);\n", "      to_frags(dp, a);\n      "
     + _stamp(0, 6)),
    ("      wgmma_wait0();\n      fence_regs(dq);\n",
     "      wgmma_wait0();\n      fence_regs(dq);\n      " + _stamp(0, 7)),
    ("// the stage may be refilled\n",
     "// the stage may be refilled\n    " + _stamp(0, 8)),
    ("             H * kD, tid);\n}",
     "             H * kD, tid);\n  " + _stamp(0, 9)
     + "  if (threadIdx.x == 0) atomicAdd(&g_stamps[15], 1ull);\n}"),
    ("G = H / KV, W = p.window;\n  const int tid = threadIdx.x, "
     "warp = tid >> 5, lane = tid & 31;\n",
     "G = H / KV, W = p.window;\n  const int tid = threadIdx.x, "
     "warp = tid >> 5, lane = tid & 31;\n  long long t_prev_ = clock64();\n"),
    ("  float dk[32], dv[32];",
     "  " + _stamp(1, 0) + "  float dk[32], dv[32];"),
    ("< n) load_step(j + kStages - 1, ahead);\n    cp_async_commit();\n",
     "< n) load_step(j + kStages - 1, ahead);\n    cp_async_commit();\n    "
     + _stamp(1, 1)),
    ("    const uint32_t qs = sQ + stage",
     "    " + _stamp(1, 2) + "    const uint32_t qs = sQ + stage"),
    ("    two_products_ss<kD>(st, sK, qs, dpt, sV, dos);\n",
     "    two_products_ss<kD>(st, sK, qs, dpt, sV, dos);\n    "
     + _stamp(1, 3)),
    ("    to_frags(dpt, sa);\n", "    to_frags(dpt, sa);\n    "
     + _stamp(1, 4)),
    ("    fence_regs(dv);\n    fence_regs(dk);\n    __syncthreads();",
     "    fence_regs(dv);\n    fence_regs(dk);\n    " + _stamp(1, 5)
     + "    __syncthreads();"),
    ("// the stage may be refilled\n  }\n  cp_async_wait<0>();\n\n  // dK",
     "// the stage may be refilled\n    " + _stamp(1, 6)
     + "  }\n  cp_async_wait<0>();\n\n  // dK"),
    ("smem_raw, sV, k0, S, KV * kD, tid);\n}",
     "smem_raw, sV, k0, S, KV * kD, tid);\n  " + _stamp(1, 7)
     + "  if (threadIdx.x == 0) atomicAdd(&g_stamps[31], 1ull);\n}"),
    ("}  // extern \"C\"",
     "int repro_flash_backward_sm90_stamps(unsigned long long* out) {\n"
     "  const unsigned long long zero[32] = {};\n"
     "  cudaMemcpyFromSymbol(out, g_stamps, sizeof(zero));\n"
     "  return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));\n}\n\n"
     "}  // extern \"C\""),
]
VARIANTS = {
    "stamps": STAMPS,
    "dq3": [("static constexpr int kDqStages = 2, kDkdvStages = 3, "
             "kDqBlocks = 4;",
             "static constexpr int kDqStages = 3, kDkdvStages = 3, "
             "kDqBlocks = 3;")],
}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant edit not found: {old!r}")
        text = text.replace(old, new, 1)
    return text


def variants(dev, card, CS, FK, names) -> dict:
    import ctypes
    import subprocess

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_backward_torch,
    )
    out_dir = ROOT / "build" / "flash_backward_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = FK.SOURCES["flash_backward_sm90"].read_text()
    srcs = []
    for name in names or VARIANTS:
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(text, VARIANTS[name]))
        srcs.append(src)

    def build(src):
        lib = out_dir / f"lib{src.stem}.so"
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                              str(lib), str(src)], capture_output=True,
                             text=True)
        return src.stem, lib, res

    with ThreadPoolExecutor(max(1, len(srcs))) as ex:
        built = list(ex.map(build, srcs))
    libs = {}
    for name, lib, res in built:
        for ln in (res.stdout + res.stderr).splitlines():
            if any(k in ln for k in ("Used", "spill", "arning", "dvisory",
                                     "erformance", "error")):
                CS.say(f"variant {name}: {ln.strip()}")
        CS.check(res.returncode == 0, f"variant {name}: nvcc failed")
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.repro_flash_backward_sm90
        fn.argtypes = [FK._CTYPE.get(a, ctypes.c_longlong)
                       for a in FK._ARGS["flash_backward_sm90"]]
        fn.restype = ctypes.c_int
        libs[name] = cdll
    main_lib = FK._library("flash_backward_sm90")
    B, S = CS.TRAIN_BATCH, CS.TRAIN_SEQ
    q, k, v, do = CS.attn_inputs(dev, B, S, torch.bfloat16, CS.SEED + 3)
    o = FK.flash_attention_cuda(q, k, v, causal=True, window=None,
                                q_start=0, kv_len=S)
    want = flash_attention_backward_torch(q, k, v, o, do)
    order = ["main"] + list(libs) + ["main"]
    rec = {}
    try:
        for name in order:
            FK._libs["flash_backward_sm90"] = libs.get(name, main_lib)
            fn = lambda: FK.flash_backward_sm90_cuda(q, k, v, o, do)
            a, b = fn(), fn()
            torch.cuda.synchronize()
            errs = [ulps(g, w) for g, w in zip(a, want)]
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            CS.check(all(e <= CS.BWD_ULPS16 for e in errs) and same,
                     f"variant {name}: ulps {errs}, bit-equal {same}")
            busy, _, by_name = CS.device_profile(
                lambda: [fn() for _ in range(20)])
            split = {kn.split("(")[1].split("::")[-1] if "(" in kn else kn:
                     t / 20 for kn, (t, _) in by_name.items()}
            rec.setdefault(name, []).append(dict(us=busy / 20, split=split,
                                                 ulps=errs))
            if hasattr(libs.get(name, main_lib),
                       "repro_flash_backward_sm90_stamps"):
                rec[name][-1]["stamps"] = stamps(libs[name], fn, CS, card)
            CS.say(f"variant {name}: {busy / 20:.2f} us a call "
                   + ", ".join(f"{kn} {t:.2f}" for kn, t in split.items())
                   + f"; ulps {[round(e, 3) for e in errs]}, two runs "
                   f"bit-equal [{card}]")
    finally:
        FK._libs["flash_backward_sm90"] = main_lib
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card")
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK
    mode = sys.argv[1] if len(sys.argv) > 1 else "check"
    names = ("flash_prefill_sm90", "flash_attention", "flash_backward",
             "flash_backward_sm90")
    with ThreadPoolExecutor(len(names)) as ex:
        libs = list(ex.map(FK.build, names))
    card = CS.card_line()
    for lib in libs[2:]:
        for ln in _build.ptxas_report(lib):
            CS.say(f"build: ptxas {lib.stem[3:]}: {ln}")
    # ptxas's advisories (a wgmma pipeline serialized, and why) beside them
    for ln in libs[3].with_suffix(".log").read_text().splitlines():
        if "arning" in ln or "dvisory" in ln or "erformance" in ln:
            CS.say(f"build: ptxas flash_backward_sm90: {ln.strip()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    rec = {"card": card}
    if mode in ("check", "all"):
        rec["check"] = check(dev, card, CS, FK)
    if mode in ("time", "all"):
        rec["time"] = timing(dev, card, CS, FK)
    if mode == "variants":
        rec["variants"] = variants(dev, card, CS, FK, sys.argv[2:])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_backward_probe.json").write_text(json.dumps(rec, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
