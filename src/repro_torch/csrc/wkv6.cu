// The RWKV-6 WKV recurrence for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `wkv6_pallas` / `_wkv6_kernel`
// (src/repro/kernels/rwkv6/kernel.py).  Per (batch b, head h), with an N x N
// f32 state S (key i x value j), data-dependent decay w_t and bonus u:
//
//   o_t[j] = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// Layouts are the public function's: r, k, v, w and o (B, T, H, N), u (H, N),
// in bf16 or f32 (one dtype for all); the initial state s0 (may be null:
// zeros) and the final state sT (B, H, N, N) f32.  sT may be s0 itself: each
// thread reads its column of s0 before the loop and writes it after, so the
// wrapper can thread a layer's cache view through in place.  N is 16, 32 or
// 64 (a template argument; the wrapper refuses others).  Any T >= 1: the
// Pallas assert T % chunk == 0 has no counterpart.
//
// Design.  The TPU kernel walks time chunks as a sequential grid axis with S
// in VMEM scratch.  Here one block of N threads owns one (b, h) for all T
// steps: thread j keeps column j of S, N floats, in registers.  Each step the
// block stages r_t, k_t and w_t in shared memory (double-buffered, one
// __syncthreads a step), each thread keeps its own v_t[j], and the next
// step's four values are loaded into registers before this step is computed,
// so their latency overlaps the arithmetic.  The state update is written with
// __fmul_rn / __fadd_rn (no FMA contraction), so the state is bit-equal to a
// plain version that spells it w * S + k * v in f32 (`wkv6_ref`); the output
// sums are taken in index order, so they agree with it to f32 rounding.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the
// tensor cores):
//   * prefill (rwkv6-7b: B 1, H 64, N 64, T 1024, bf16): operations, about
//     5 N^2 f32 flops per head and step, 1.34 GFLOP, 20 us; the bytes (r, k,
//     v, w read once, o written once, the state read and written once) are
//     44 MB, 13 us.
//   * decode (T 1): bytes, the state read and written once: 2.1 MB, 0.63 us.
// What the simple design leaves on the table:
//   * B * H = 64 blocks of 2 warps on 132 SMs, and each step is a chain of N
//     dependent f32 adds: latency-bound, far from either bound.  Splitting
//     the key index i over more threads (partial sums merged in shared
//     memory) and a chunked (GLA-style) form with tensor-core products for
//     prefill are the fixes;
//   * the per-step loads are 2-byte scalars, not 16-byte vectors.
// Both are later work; this kernel is the simple one that is right.

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
