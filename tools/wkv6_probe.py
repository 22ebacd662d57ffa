#!/usr/bin/env python3
"""Variants of the WKV-6 kernel (``csrc/wkv6.cu``) timed against each other
and against the kernel it replaced, on one CUDA card.  Run from the root of
a checkout:

    python3 tools/wkv6_probe.py [variant ...]

Each variant is ``csrc/wkv6.cu`` with its decomposition constants edited
(or, for ``old``, the kernel the repository had before the column-tiled
design), built into ``build/wkv6_probe/`` (the repository's source is not
changed) and bound in place of the library ``wkv6_cuda`` loads, so every
call goes through the wrapper as on the serving path:

  main        the source as it is: tiles of 16 columns, 8 lanes a column
              (8 rows each), one column a thread, chunks of 16 steps
  jt8, jt32, jt64  tiles of 8, 32 or 64 columns (twice, a half or a
              quarter of the blocks)
  r4, r16     4 or 16 lanes a column (16 or 4 rows each)
  c8, c32     chunks of 8 or 32 steps
  cj2, cj4    2 or 4 columns a thread (a half or a quarter of the threads)
  jt32cj2, cj2c32  two of the above combined
  nodecode    a launch of one step takes the chunked path too (no
              one-step path)
  stamps      main with clock64() stamps of thread 0 of block 0 (at
              prefill; the decode path has no phases): cycles a launch in
              the prologue, the chunk's wait and barrier, the
              last chunk's outputs and this chunk's bonuses, the second
              barrier, the next chunk's staging and the last one's stores,
              this chunk's steps, and the epilogue
  old         one block of N threads a (b, h), thread j owning column j,
              one barrier and 2-byte loads a step (PRs 13-15)

Shapes: rwkv6-7b's decode (B 1, T 1, H 64, N 64) and prefill (T 1024),
bf16, with the state threaded in place as the serving path does.  Each
variant is first checked against ``wkv6_ref`` at the prefill shape (final
state bit-equal, outputs within ``chip_smoke.py``'s phase-4 bound), then
timed: device us per launch (the mean over the launches a
``torch.profiler`` trace holds, or CUDA events where no trace comes
back).  The variants run in turns, main first and last; naming variants
runs only those (and main).  One line per measurement with the card's
name and power limit; all of it as JSON in ``chiprun_out/wkv6_probe.json``.
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

OUT = ROOT / "build" / "wkv6_probe"

# The kernel of PRs 13-15, whole: same C entries, no constants entry.
OLD_SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const T* __restrict__ u, const float* s0, T* __restrict__ o,
                float* sT, long long steps, long long H) {
  __shared__ float rs[2][N], ks[2][N], ws[2][N], us[N];
  const long long bh = blockIdx.x;
  const long long b = bh / H, h = bh % H;
  const int j = threadIdx.x;

  float S[N];  // column j of the state: S[i] = state[i][j]
  const long long sbase = bh * N * N + j;
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 ? s0[sbase + (long long)i * N] : 0.f;
  us[j] = to_f32(u[h * N + j]);

  const long long stride = H * N;                   // one time step
  long long cur = (b * steps * H + h) * N + j;       // element (b, 0, h, j)
  float rn = to_f32(r[cur]), kn = to_f32(k[cur]);
  float wn = to_f32(w[cur]), vn = to_f32(v[cur]);
  for (long long t = 0; t < steps; ++t) {
    const int buf = (int)(t & 1);
    rs[buf][j] = rn;
    ks[buf][j] = kn;
    ws[buf][j] = wn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < steps) {          // the next step's loads, in flight below
      const long long nxt = cur + stride;
      rn = to_f32(r[nxt]);
      kn = to_f32(k[nxt]);
      wn = to_f32(w[nxt]);
      vn = to_f32(v[nxt]);
    }
    float bonus = 0.f, acc = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float ri = rs[buf][i], ki = ks[buf][i];
      bonus = __fadd_rn(bonus, __fmul_rn(__fmul_rn(ri, us[i]), ki));
      acc = __fadd_rn(acc, __fmul_rn(ri, S[i]));
      S[i] = __fadd_rn(__fmul_rn(ws[buf][i], S[i]), __fmul_rn(ki, vj));
    }
    store(o + cur, __fadd_rn(acc, __fmul_rn(bonus, vj)));
    cur += stride;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) sT[sbase + (long long)i * N] = S[i];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* s0, void* o, float* sT, long long B,
           long long steps, long long H, cudaStream_t stream) {
  wkv6_kernel<T, N><<<(unsigned)(B * H), N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s0, static_cast<T*>(o), sT, steps, H);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* o, void* sT, long long B,
             long long steps, long long H, long long N, cudaStream_t stream) {
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  if (N == 16)
    return launch<T, 16>(r, k, v, w, u, s0f, o, sTf, B, steps, H, stream);
  if (N == 32)
    return launch<T, 32>(r, k, v, w, u, s0f, o, sTf, B, steps, H, stream);
  if (N == 64)
    return launch<T, 64>(r, k, v, w, u, s0f, o, sTf, B, steps, H, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  s0 may be null (a zero initial state); sT may equal
// s0.  The wrapper has checked shapes, dtypes, contiguity, T >= 1 and N.
int repro_wkv6_bf16(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* s0, void* o,
                    void* sT, long long B, long long T, long long H,
                    long long N, void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, o, sT, B, T, H, N,
                                 static_cast<cudaStream_t>(stream));
}

int repro_wkv6_f32(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* o,
                   void* sT, long long B, long long T, long long H,
                   long long N, void* stream) {
  return dispatch<float>(r, k, v, w, u, s0, o, sT, B, T, H, N,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
"""

JT = "constexpr int kTileCols = 16;"
RS = "constexpr int kRowSplit = 8;"
CH = "constexpr int kChunk = 16;"
CJ = "constexpr int kColsThread = 1;"
# the stamps variant: anchors in the kernel, and what follows each
STAMPS = [
    ("template <typename T, int N, bool kVec>\n__global__",
     "__device__ unsigned long long g_stamps[16];\n"
     "#define STAMP(i) if (blockIdx.x == 0 && threadIdx.x == 0) { "
     "const long long t_ = clock64(); g_stamps[i] += t_ - t_prev; "
     "t_prev = t_; }\n"
     "template <typename T, int N, bool kVec>\n__global__"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  long long t_prev = clock64();\n"
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"),
    ("      S[q][m] = st[(g * RT + m) * L::kPitch + jl + q];\n    }\n  }\n",
     "      S[q][m] = st[(g * RT + m) * L::kPitch + jl + q];\n    }\n  }\n"
     "  STAMP(0);\n"),
    ("    // chunk c staged; chunk c - 1's steps done\n"
     "    __syncthreads();\n",
     "    // chunk c staged; chunk c - 1's steps done\n"
     "    __syncthreads();\n    STAMP(1);\n"),
    ("    // chunk c - 1's outputs gathered and its staging buffer free\n"
     "    __syncthreads();\n",
     "    STAMP(2);\n    __syncthreads();\n    STAMP(3);\n"),
    ("    if (c > 0) store_out(t0 - C, C);\n",
     "    if (c > 0) store_out(t0 - C, C);\n    STAMP(4);\n"),
    ("      for (int s = 0; s < cs; ++s) step(rows + s * L::kRawRow, s);\n"
     "    }\n",
     "      for (int s = 0; s < cs; ++s) step(rows + s * L::kRawRow, s);\n"
     "    }\n    STAMP(5);\n"),
    ("    sT[sbase + static_cast<long long>(i) * N + jj] = "
     "st[i * L::kPitch + jj];\n  }\n}\n",
     "    sT[sbase + static_cast<long long>(i) * N + jj] = "
     "st[i * L::kPitch + jj];\n  }\n  STAMP(6);\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_stamps[15] += 1;\n}\n"),
    ("}  // extern \"C\"",
     "int repro_wkv6_stamps(unsigned long long* out) {\n"
     "  const unsigned long long zero[16] = {};\n"
     "  cudaMemcpyFromSymbol(out, g_stamps, sizeof(zero));\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, zero, "
     "sizeof(zero)));\n}\n\n}  // extern \"C\""),
]
STAMP_NAMES = ("prologue", "wait+barrier", "outputs+bonus", "barrier2",
               "stage+store", "steps", "epilogue")

VARIANTS = {
    "main": [],
    "jt8": [(JT, "constexpr int kTileCols = 8;")],
    "jt32": [(JT, "constexpr int kTileCols = 32;")],
    "jt64": [(JT, "constexpr int kTileCols = 64;")],
    "r4": [(RS, "constexpr int kRowSplit = 4;")],
    "r16": [(RS, "constexpr int kRowSplit = 16;")],
    "c8": [(CH, "constexpr int kChunk = 8;")],
    "c32": [(CH, "constexpr int kChunk = 32;")],
    "cj2": [(CJ, "constexpr int kColsThread = 2;")],
    "cj4": [(CJ, "constexpr int kColsThread = 4;")],
    "jt32cj2": [(JT, "constexpr int kTileCols = 32;"),
                (CJ, "constexpr int kColsThread = 2;")],
    "cj2c32": [(CJ, "constexpr int kColsThread = 2;"),
               (CH, "constexpr int kChunk = 32;")],
    "nodecode": [("    if (steps == 1) {", "    if (false) {")],
    "stamps": STAMPS,
    "old": None,
}
ORDER = ("main", "old", "jt8", "jt32", "jt64", "r4", "r16", "c8", "c32", "cj2",
         "cj4", "jt32cj2", "cj2c32", "nodecode", "stamps", "main")


def variant(name: str, edits) -> Path:
    """Build ``csrc/wkv6.cu`` with each old of ``edits`` replaced by its new
    (``None``: the old kernel); returns the library's path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6 import kernel as WK
    if edits is None:
        text = OLD_SOURCE
    else:
        text = WK.SOURCE.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"wkv6.cu: the probe's anchor is gone: "
                                 f"{old!r}")
            text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"wkv6_{name}.cu"
    path.write_text(text)
    return _build.build(path, f"wkv6_{name}")


def bind(path: Path) -> ctypes.CDLL:
    """The library at ``path`` with the argument types ``wkv6_cuda``
    expects (as ``kernel._library`` declares them)."""
    lib = ctypes.CDLL(str(path))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for sfx in ("bf16", "f32"):
        fn = getattr(lib, f"repro_wkv6_{sfx}")
        fn.argtypes = [vp] * 8 + [ll] * 4 + [vp]
        fn.restype = ctypes.c_int
    return lib


def inputs(T, H, N, dev, gen):
    """rwkv6-7b's bf16 inputs at T steps and an f32 initial state, drawn
    as ``chip_smoke.py`` draws them."""
    r, k, v = (torch.randn(1, T, H, N, device=dev, generator=gen)
               .bfloat16() for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(1, T, H, N, device=dev,
                                         generator=gen))).bfloat16()
    u = (0.5 * torch.randn(H, N, device=dev, generator=gen)).bfloat16()
    s0 = torch.randn(1, H, N, N, device=dev, generator=gen)
    return r, k, v, w, u, s0


def check_variant(name, args):
    """The variant must be right before it is timed."""
    import chip_smoke as CS
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    r, k, v, w, u, s0 = args
    o, sT = WK.wkv6_cuda(r, k, v, w, u, initial_state=s0)
    ow, sw = wkv6_ref(r, k, v, w, u, s0)
    mag = wkv6_ref(r.abs(), k.abs(), v.abs(), w, u.abs(), s0.abs())[0]
    e, ok, _ = CS.wkv6_err(o, ow, mag, r.shape[-1])
    CS.check(ok and torch.equal(sT, sw),
             f"variant {name}: output max abs err {e}, state bit-equal "
             f"{torch.equal(sT, sw)}")
    return e


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this probe needs a "
              "CUDA card", flush=True)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6 import kernel as WK

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
            print(f"probe: ptxas {name}: {ln}", flush=True)
    H, N = 64, 64                     # rwkv6-7b: 64 heads of 64
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 7)
    shapes = {"decode": inputs(1, H, N, dev, gen),
              "prefill": inputs(1024, H, N, dev, gen)}
    check_args = inputs(1024, H, N, dev, gen)

    def run(r, k, v, w, u, s0):
        return WK.wkv6_cuda(r, k, v, w, u, initial_state=s0, state_out=s0)

    results = {"card": card}
    stamps = (ctypes.c_ulonglong * 16)()
    for i, name in enumerate(ORDER):
        if name not in libs:
            continue
        WK._lib = bind(libs[name])
        if name == "stamps":
            WK._lib.repro_wkv6_stamps.argtypes = [ctypes.c_void_p]
            WK._lib.repro_wkv6_stamps.restype = ctypes.c_int
        err = check_variant(name, check_args)
        res = {"max_abs_err": err}
        for label, args in shapes.items():
            reps = 20 if label == "decode" else 3
            ms = CS.time_replay([args], run, reps=reps, one_launch=True)[0]
            res[f"{label}_ms"] = ms
            print(f"probe: {name} {label} ({tuple(args[0].shape)} bf16): "
                  f"device us per launch {ms * 1e3:.2f} [{card}]",
                  flush=True)
            if name == "stamps" and label == "prefill":
                WK._lib.repro_wkv6_stamps(stamps)     # zero the counts
                run(*args)
                torch.cuda.synchronize()
                WK._lib.repro_wkv6_stamps(stamps)
                n = max(1, stamps[15])
                res[f"{label}_cycles"] = {k: stamps[j] / n for j, k in
                                          enumerate(STAMP_NAMES)}
                print(f"probe: stamps {label}: cycles of thread 0 of block "
                      f"0 a launch {res[f'{label}_cycles']} [{card}]",
                      flush=True)
        results[f"{name}#{i}"] = res
    out = ROOT / "chiprun_out" / "wkv6_probe.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"probe: wrote {out.relative_to(ROOT)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
