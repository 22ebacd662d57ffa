#!/usr/bin/env python3
"""Variants of the staged RG-LRU kernel (``csrc/rglru.cu``) timed against
each other and against the step kernel, on one CUDA card.  Run from the
root of a checkout:

    python3 tools/rglru_probe.py [variant ...]

Each variant is ``csrc/rglru.cu`` with a few edits, built into
``build/rglru_probe/`` (the repository's source is not changed) and bound
in place of the library ``rglru_staged_cuda`` loads, so every call goes
through the wrapper as on the serving path:

  main        the source as it is: blocks of 32 channels, chunks of 128
              steps, a ring of 3 chunks (2 in flight), 3 sets of three
              compute warps, the walker alone on its scheduler, a and b
              read 4 quads of steps ahead, the gates' square root by
              sqrt_unit
  shared      the walker warp and 9 compute warps numbered in a row, so
              that two compute warps share the walker's scheduler
  ch16        blocks of 16 channels (twice the blocks)
  ch64_c64    blocks of 64 channels (two walker warps, half the blocks),
              chunks of 64 (128 do not fit in shared memory)
  c32, c64    chunks of 32 or 64 steps
  s2, s4      rings of 2 or 4 chunks (1 or 3 in flight)
  sets2, sets4  2 or 4 sets of compute warps (6 or 12)
  b2, b8      the walker reads 2 or 8 quads ahead
  sqrtf       the gates' square root by sqrtf (a branch to its slow path
              for each element)
  bulk        loads by 1-D bulk copies (TMA, ``cp.async.bulk`` with one
              mbarrier a ring slot), one row of the block's channels a
              copy, issued by the first compute warp, instead of each
              compute thread's 16-byte cp.async (Griffin's width only:
              rows must be whole 16-byte blocks)
  nobatch     the walker reads a and b step by step
  stamps, stamps_shared  main (shared) with clock64() stamps of block
              0's walker lane 0 and first compute thread: cycles a launch
              walking (with its stores of h), issuing copies, waiting for
              loads, computing the gates, and each at the barrier
  walkonly, nostore, walkonly_nostore  diagnostics, timed and not
              checked: the compute warps stage and compute nothing, the
              walker stores nothing, or both

and ``step``, the step kernel (the first RG-LRU kernel, one thread a
channel) at the same shapes through ``rglru_step_cuda``.  Before the
variants, ``sqrt_unit`` is checked against ``sqrtf`` at every float of
its domain (0 and 2^-24 .. 1) in a kernel of its own.

Shapes: recurrentgemma-2b's prefill (B 1, T 2560, D 2560, gx bf16, h0
given, the final state over h0 as the serving path threads it), and its
decode (T 1) through the step kernel; then, for main, both kernels at T
1, 2, 3, 4, 8, 16, 64 and 128 (the route threshold).  Each variant is
first checked against ``rglru_ref`` at the prefill shape (h and hT
bit-equal to the step kernel, within ``chip_smoke.py``'s tolerances of
the plain version), then timed: device us per launch (the mean over the
launches a ``torch.profiler`` trace holds, or CUDA events where no trace
comes back).  The variants run in turns, main first and last; naming
variants runs only those (and main).  One line per measurement with the
card's name and power limit; all of it as JSON in
``chiprun_out/rglru_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "rglru_probe"

CH = "constexpr int kChannels = 32;"
CK = "constexpr int kChunk = 128;"
ST = "constexpr int kStages = 3;"
SE = "constexpr int kSets = 3;"
KB = "constexpr int kBatch = 4;"
# walker and compute warps sharing the schedulers: the walker warp first,
# then 3 * kSets compute warps
SHARED = [("constexpr int kWarps = 4 * kSets;",
           "constexpr int kWarps = kWalkWarps + 3 * kSets;"),
          (None, ("  if (w % 4 != 0) return", "  return {-1, -1};\n}"),
           "  (void)lane;\n"
           "  if (w < kWalkWarps) return {tid, -1};\n"
           "  return {-1, tid - 32 * kWalkWarps};\n"),
          ("  return {-1, -1};\n}", "}")]

STAMPS = [
    ("#include <cuda_bf16.h>",
     "__device__ unsigned long long g_stamps[16];\n"
     "#define RGLRU_STAMP_START long long t_prev_ = clock64();\n"
     "#define RGLRU_STAMP(i) if (blockIdx.x == 0 && (threadIdx.x == 0 || "
     "threadIdx.x == 32 * kWalkWarps)) { const long long t_ = clock64(); "
     "g_stamps[(i)] += t_ - t_prev_; t_prev_ = t_; }\n"
     "#include <cuda_bf16.h>"),
    ("  if (live) hT[b * D + k.d0 + r.walk] = carry;\n}\n",
     "  if (live) hT[b * D + k.d0 + r.walk] = carry;\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_stamps[15] += 1;\n}\n"),
    ("}  // extern \"C\"",
     "int repro_rglru_stamps(unsigned long long* out) {\n"
     "  const unsigned long long zero[16] = {};\n"
     "  cudaMemcpyFromSymbol(out, g_stamps, sizeof(zero));\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, zero, "
     "sizeof(zero)));\n}\n\n}  // extern \"C\""),
]
STAMP_NAMES = {0: "walker: steps and stores of h", 1: "walker: barrier",
               2: "compute: issue copies", 4: "compute: wait for loads",
               5: "compute: gates", 6: "compute: barrier"}

# the bulk (TMA) body: stage_chunk replaced, the cp.async wait replaced by
# the ring slot's mbarrier, the mbarriers made before the prologue
BULK_STAGE = r'''__shared__ alignas(8) unsigned long long g_bar[kStages];

// Rows of chunk c into ring slot c % kStages by 1-D bulk copies: row s of
// la and of gx (the block's channels, whole 16-byte blocks) by lane s % 32
// of the first compute warp, completing on the slot's mbarrier.
template <typename T, int kV>
__device__ __forceinline__ void stage_chunk(unsigned char* sm, const Block& k,
                                            int c, const float* la,
                                            const T* gx, int ct) {
  using L = Smem<T>;
  if (ct >= 32) return;
  const int slot = c % kStages;
  float* rla = reinterpret_cast<float*>(sm + L::kRawLa) + slot * kTile;
  T* rx = reinterpret_cast<T*>(sm + L::kRawX) + slot * kTile;
  const long long t0 = static_cast<long long>(c) * kChunk;
  const int rows = static_cast<int>(k.steps - t0 < kChunk ? k.steps - t0
                                                          : kChunk);
  const long long left = k.D - k.d0;
  const int nc = static_cast<int>(left < kChannels ? left : kChannels);
  const unsigned int lb = 4u * nc, xb = static_cast<unsigned int>(sizeof(T)) * nc;
  const unsigned int bar =
      static_cast<unsigned int>(__cvta_generic_to_shared(&g_bar[slot]));
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (ct == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(static_cast<unsigned int>(rows) * (lb + xb))
        : "memory");
  }
  for (int s = ct; s < rows; s += 32) {
    const long long i = (k.row0 + t0 + s) * k.D + k.d0;
    const unsigned int dl = static_cast<unsigned int>(
        __cvta_generic_to_shared(rla + s * kChannels));
    const unsigned int dx = static_cast<unsigned int>(
        __cvta_generic_to_shared(rx + s * kChannels));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dl),
        "l"(la + i), "r"(lb), "r"(bar)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(dx),
        "l"(gx + i), "r"(xb), "r"(bar)
        : "memory");
  }
}

'''
BULK = [
    (None, ("template <typename T, int kV>\n__device__ __forceinline__ void "
            "stage_chunk", "// a and b of chunk c"), BULK_STAGE),
    ("        asm volatile(\"cp.async.wait_group %0;\\n\" ::\"n\"(kStages - 1)\n"
     "                     : \"memory\");\n",
     "        {\n"
     "          const unsigned int bar = static_cast<unsigned int>(\n"
     "              __cvta_generic_to_shared(&g_bar[i % kStages]));\n"
     "          const unsigned int par = (i / kStages) & 1;\n"
     "          asm volatile(\"{\\n.reg .pred P1;\\nLAB_WAIT:\\n\"\n"
     "                       \"mbarrier.try_wait.parity.shared::cta.b64 P1, "
     "[%0], %1;\\n\"\n"
     "                       \"@!P1 bra LAB_WAIT;\\n}\\n\" ::\"r\"(bar), "
     "\"r\"(par)\n"
     "                       : \"memory\");\n"
     "        }\n"),
    ("  if (r.compute >= 0) {\n    for (int c = 0; c < kStages - 1; ++c) {",
     "  if (threadIdx.x == 0) {\n"
     "    for (int q = 0; q < kStages; ++q) {\n"
     "      const unsigned int a = static_cast<unsigned int>(\n"
     "          __cvta_generic_to_shared(&g_bar[q]));\n"
     "      asm volatile(\"mbarrier.init.shared::cta.b64 [%0], 1;\\n\" "
     "::\"r\"(a));\n"
     "    }\n"
     "    asm volatile(\"fence.mbarrier_init.release.cluster;\\n\" ::: "
     "\"memory\");\n"
     "  }\n"
     "  __syncthreads();\n"
     "  if (r.compute >= 0) {\n    for (int c = 0; c < kStages - 1; ++c) {"),
]

NOBATCH = [(None, ("  if (n == kChunk) {      // no branch between the steps",
                   "  } else {\n    const float* fa"),
            "  if (false) {\n")]

NOSTORE = [("        for (int j = 0; j < 4 * kBatch; ++j) store(hp + j * D, "
            "hv[j]);\n", "        for (int j = 0; j < 4 * kBatch; ++j) "
            "(void)hv[j];\n")]
# the staged kernel with sqrtf (its branch) in place of sqrt_unit
SQRTF = [("        b[j] = gate_b_unit(l[m][j], x[m][j]);",
          "        b[j] = gate_b(l[m][j], x[m][j]);")]

VARIANTS = {
    "main": [],
    "shared": SHARED,
    "ch16": [(CH, "constexpr int kChannels = 16;")],
    "ch64_c64": [(CH, "constexpr int kChannels = 64;"),
                 (CK, "constexpr int kChunk = 64;")],
    "c32": [(CK, "constexpr int kChunk = 32;")],
    "c64": [(CK, "constexpr int kChunk = 64;")],
    "s2": [(ST, "constexpr int kStages = 2;")],
    "s4": [(ST, "constexpr int kStages = 4;")],
    "sets2": [(SE, "constexpr int kSets = 2;")],
    "sets4": [(SE, "constexpr int kSets = 4;")],
    "b2": [(KB, "constexpr int kBatch = 2;")],
    "b8": [(KB, "constexpr int kBatch = 8;")],
    "sqrtf": SQRTF,
    "bulk": BULK,
    "nobatch": NOBATCH,
    "stamps": STAMPS,
    "stamps_shared": STAMPS + SHARED,
}
# diagnostics that break the result on purpose: timed, not checked
WALKONLY = [("        transform_chunk<T>(sm, i, r.compute);\n", ""),
            ("          stage_chunk<T, kV>(sm, k, i + kStages - 1, la, gx, "
             "r.compute);\n", "")]
VARIANTS.update({
    "walkonly": WALKONLY,
    "nostore": NOSTORE,
    "walkonly_nostore": WALKONLY + NOSTORE,
})
UNCHECKED = {"walkonly", "nostore", "walkonly_nostore"}
ORDER = ("main", "step", *(k for k in VARIANTS if k != "main"), "main")
SWEEP_T = (1, 2, 3, 4, 8, 16, 64, 128)


# every v in the staged kernel's domain of sqrt_unit: 0 and the floats
# from 2^-24 to 1
SQRT_CHECK = r'''
#include <cuda_runtime.h>
%s
__global__ void sqrt_check(unsigned int lo, unsigned int n,
                           unsigned long long* bad, unsigned int* first) {
  for (unsigned int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const unsigned int u = i == 0 ? 0u : lo + i - 1;
    const float v = __uint_as_float(u);
    if (__float_as_uint(sqrt_unit(v)) != __float_as_uint(sqrtf(v))) {
      atomicAdd(bad, 1ull);
      atomicMin(first, u);
    }
  }
}
extern "C" int repro_sqrt_check(unsigned long long* out) {
  unsigned long long* bad;
  unsigned int* first;
  cudaMalloc(&bad, 8);
  cudaMalloc(&first, 4);
  cudaMemset(bad, 0, 8);
  cudaMemset(first, 0xff, 4);
  const unsigned int lo = 0x33800000u, n = 0x3f800000u - lo + 2;
  sqrt_check<<<1024, 256>>>(lo, n, bad, first);
  unsigned int f = 0;
  cudaMemcpy(&out[0], bad, 8, cudaMemcpyDeviceToHost);
  cudaMemcpy(&f, first, 4, cudaMemcpyDeviceToHost);
  out[1] = f;
  out[2] = n;
  cudaFree(bad);
  cudaFree(first);
  return static_cast<int>(cudaGetLastError());
}
'''


def sqrt_exhaustive() -> dict:
    """sqrt_unit of csrc/rglru.cu against sqrtf at every float of its
    domain: mismatches, the first one's bits, values checked."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import kernel as RK
    text = RK.SOURCE.read_text()
    i = text.index("__device__ __forceinline__ float sqrt_unit")
    j = text.index("\n}\n", i) + 3
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "sqrt_check.cu"
    path.write_text(SQRT_CHECK % text[i:j])
    lib = ctypes.CDLL(str(_build.build(path, "sqrt_check")))
    out = (ctypes.c_ulonglong * 3)()
    lib.repro_sqrt_check.argtypes = [ctypes.c_void_p]
    err = lib.repro_sqrt_check(out)
    return {"mismatches": out[0], "first": hex(out[1]), "checked": out[2],
            "cuda_error": err}


def edit(text: str, edits) -> str:
    """Each (old, new) replaced; (None, (start, end), new) replaces the
    text from start up to (not including) end."""
    for e in edits:
        if e[0] is None:
            (start, end), new = e[1], e[2]
            i, j = text.find(start), text.find(end)
            if i < 0 or j < i:
                raise SystemExit(f"rglru.cu: the probe's anchors are gone: "
                                 f"{start!r} .. {end!r}")
            text = text[:i] + new + text[j:]
        else:
            old, new = e
            if old not in text:
                raise SystemExit(f"rglru.cu: the probe's anchor is gone: "
                                 f"{old!r}")
            text = text.replace(old, new)
    return text


def variant(name: str, edits) -> Path:
    """Build ``csrc/rglru.cu`` with ``edits``; returns the library's path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import kernel as RK
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"rglru_{name}.cu"
    path.write_text(edit(RK.SOURCE.read_text(), edits))
    return _build.build(path, f"rglru_{name}")


def bind(path: Path):
    """The library at ``path`` with the argument types the wrappers expect
    (as ``kernel._library`` declares them), and the constants it reports."""
    lib = ctypes.CDLL(str(path))
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for sfx in ("bf16", "f32"):
        fn = getattr(lib, f"repro_rglru_step_{sfx}")
        fn.argtypes = [vp] * 5 + [ll] * 3 + [vp]
        fn.restype = i
        fn = getattr(lib, f"repro_rglru_staged_{sfx}")
        fn.argtypes = [vp] * 5 + [ll] * 3 + [i, vp]
        fn.restype = i
    got = (ctypes.c_int * 4)()
    lib.repro_rglru_constants.argtypes = [vp]
    lib.repro_rglru_constants(got)
    return lib, tuple(got)


def inputs(T, D, dev, gen):
    """recurrentgemma-2b's inputs at T steps (gx bf16) and an f32 h0, drawn
    as ``chip_smoke.py`` draws them."""
    la = -0.5 * torch.exp(torch.randn(1, T, D, device=dev, generator=gen))
    gx = torch.randn(1, T, D, device=dev, generator=gen).bfloat16()
    return la, gx, torch.randn(1, D, device=dev, generator=gen)


def check_variant(name, la, gx, h0):
    """The variant must be right before it is timed: bit-equal to the step
    kernel, within tolerance of the plain version."""
    import chip_smoke as CS
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_ref
    h, hT = RK.rglru_staged_cuda(la, gx, h0)
    hs, hTs = RK.rglru_step_cuda(la, gx, h0)
    hw, hTw = rglru_ref(la, gx, h0)
    e, ok = CS.fa_err(h, hw)
    CS.check(torch.equal(h, hs) and torch.equal(hT, hTs) and ok
             and torch.allclose(hT, hTw, rtol=CS.RG_RTOL, atol=CS.RG_ATOL),
             f"variant {name}: not bit-equal to the step kernel, or h max "
             f"abs err {e} against the plain version")
    return e


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this probe needs a "
              "CUDA card", flush=True)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import kernel as RK

    dev = torch.device("cuda", torch.cuda.current_device())
    card = CS.card_line()
    asked = set(sys.argv[1:]) | {"main"}
    todo = {k: v for k, v in VARIANTS.items()
            if len(asked) == 1 or k in asked}

    def built(kv):
        try:
            return variant(*kv)
        except _build.KernelBuildError as e:     # reported, not timed
            print(f"probe: variant {kv[0]} does not build: {e}", flush=True)
            return None

    with ThreadPoolExecutor(len(todo)) as ex:
        libs = {k: v for k, v in zip(todo, ex.map(built, todo.items()))
                if v is not None}
    for name, lib in libs.items():
        for ln in _build.ptxas_report(lib):
            if "staged" in ln or "Used" in ln or "spill" in ln:
                print(f"probe: ptxas {name}: {ln}", flush=True)
    D = 2560                          # recurrentgemma-2b's lru_width
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 8)
    shapes = {"decode": inputs(1, D, dev, gen),
              "prefill": inputs(2560, D, dev, gen)}
    check_args = inputs(2560, D, dev, gen)

    def staged(la, gx, h0):
        return RK.rglru_staged_cuda(la, gx, h0, state_out=h0)

    def step(la, gx, h0):
        return RK.rglru_step_cuda(la, gx, h0, state_out=h0)

    results = {"card": card, "sqrt_unit": sqrt_exhaustive()}
    print(f"probe: sqrt_unit against sqrtf over its whole domain: "
          f"{results['sqrt_unit']}", flush=True)
    stamps = (ctypes.c_ulonglong * 16)()
    main_lib = bind(libs["main"])
    for i, name in enumerate(ORDER):
        if name == "step":
            lib, consts, fn = *main_lib, step
        elif name in libs:
            lib, consts = bind(libs[name])
            fn = staged
        else:
            continue
        RK._lib = lib
        err = None if name in UNCHECKED else check_variant(name,
                                                           *check_args)
        res = {"constants": consts, "max_abs_err": err}
        for label, args in shapes.items():
            if label == "decode" and name != "step":
                continue
            reps = 20 if label == "decode" else 5
            ms = CS.time_replay([args], fn, reps=reps, one_launch=True)[0]
            res[f"{label}_ms"] = ms
            print(f"probe: {name} {label} ({tuple(args[1].shape)} bf16): "
                  f"device us per launch {ms * 1e3:.2f} [{card}]",
                  flush=True)
        if name.startswith("stamps"):
            lib.repro_rglru_stamps.argtypes = [ctypes.c_void_p]
            lib.repro_rglru_stamps(stamps)            # zero the counts
            staged(*shapes["prefill"])
            torch.cuda.synchronize()
            lib.repro_rglru_stamps(stamps)
            n = max(1, stamps[15])
            res["prefill_cycles"] = {v: stamps[j] / n
                                     for j, v in STAMP_NAMES.items()}
            print(f"probe: stamps prefill: cycles of block 0 a launch "
                  f"{res['prefill_cycles']} [{card}]", flush=True)
        results[f"{name}#{i}"] = res
    RK._lib = main_lib[0]
    sweep = {}
    for T in SWEEP_T:
        args = inputs(T, D, dev, gen)
        row = {r: CS.time_replay([args], f, reps=20, one_launch=True)[0]
               for r, f in (("step", step), ("staged", staged))}
        sweep[T] = row
        print(f"probe: T {T} (D {D} bf16): device us per launch step "
              f"{row['step'] * 1e3:.2f}, staged {row['staged'] * 1e3:.2f}; "
              f"pick_route {RK.pick_route(T)} [{card}]", flush=True)
    results["route_sweep"] = sweep
    out = ROOT / "chiprun_out" / "rglru_probe.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"probe: wrote {out.relative_to(ROOT)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
