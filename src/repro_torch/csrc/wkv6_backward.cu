// The gradient of the RWKV-6 WKV recurrence for Hopper (sm_90a), with a
// plain C interface.
//
// It replaces no TPU kernel: `repro` differentiates the recurrence's scan
// (`jax.value_and_grad` in src/repro/launch/steps.py, through
// src/repro/kernels/rwkv6/ref.py:wkv6_ref).  It is the backward of
// csrc/wkv6.cu's forward.  Per (batch b, head h), with the N x N f32 state
// S (key i x value j), S_{t-1} the state entering step t:
//
//   forward   o_t[j] = sum_i r_t[i] S_{t-1}[i][j] + b_t v_t[j],
//             b_t = sum_i r_t[i] u[i] k_t[i],
//             S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   backward  G = dsT (zeros when null), then from the last step down:
//             dr_t[i] = sum_j S_{t-1}[i][j] do_t[j] + u[i] k_t[i] (v_t.do_t)
//             dk_t[i] = sum_j G[i][j] v_t[j] + u[i] r_t[i] (v_t.do_t)
//             dv_t[j] = sum_i G[i][j] k_t[i] + b_t do_t[j]
//             dw_t[i] = sum_j G[i][j] S_{t-1}[i][j]
//             G <- diag(w_t) G + r_t do_t^T;  ds0 = the last G
//             du[i] = sum over b and t of r_t[i] k_t[i] (v_t.do_t)
//
// Layouts are the forward's: r, k, v, w, do and the gradients (B, T, H, N)
// in bf16 or f32 (one dtype), u and du (H, N), s0, dsT and ds0 (B, H, N, N)
// f32; s0 and dsT may be null.  N is 16, 32 or 64.
//
// The trap: dr and dw need S_{t-1} while G runs backward, and S_{t-1}
// cannot be recovered backward: (S_t - k v^T) / w_t divides by a w that
// rounds to exactly 0 once exp(omega) passes ~90, and in bf16 to exactly 1
// below ~2^-9.  So the states are recomputed forward, from f32 checkpoints:
//   1. forward: the state walked as the forward kernel rounds it
//      (__fadd_rn(__fmul_rn(w, S), __fmul_rn(k, v))), written to the
//      checkpoint scratch (B, H, ceil(T / C), N, N) f32 before each chunk
//      of C = kChunk steps;
//   2. reverse, chunk by chunk from the last: the chunk's checkpoint read,
//      its C states walked again into registers, then its steps from the
//      last down, each in the order above; the chunk's outputs stored at
//      its end.
// The recomputed states are the forward's bit for bit, so nothing is
// divided and nothing cancels.
//
// Design.  One block a (b, h) holds the whole state: thread (i, cg) owns
// row i and the kCols columns [kCols cg, kCols cg + kCols), CG = N / kCols
// threads a row on neighbouring lanes, N * CG threads a block (512 at N
// 64; B * H = 512 blocks at rwkv6-7b's training shape).  So every sum stays
// in the block and nothing is added across blocks but du:
//   * row sums (dr, dk, dw): a thread's FMA chain over its columns, the CG
//     lanes merged by a butterfly (xor 1, 2, ..., CG / 2);
//   * column sums (dv): the products G k rounded, merged over the warp's RW
//     = 32 / CG rows by a butterfly (xor CG, ..., 16), each warp's sums
//     into shared memory, added over the warps in order at the chunk's end;
//   * b_t and v_t.do_t: a sequential sum each, from the first term, by one
//     thread a step and sum;
//   * du: each (b, h)'s terms added from the last step down by its row's
//     threads, written as (B, H, N) partials, summed over b in order by a
//     second kernel (no atomics: two runs give the same bits).
// A chunk of r, k, w, v and do is staged in shared memory as f32, its
// loads issued into registers while the chunk before it is computed (four
// barriers a chunk in reverse: staging, its bonuses, its outputs).
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the
// tensor cores), at rwkv6-7b's training shape (B 8, T 256, H 64, N 64,
// bf16, dsT given as autograd gives it, no s0): the operations the
// gradient needs, ~14 N^2 a head and step (the state walked forward once,
// 3 N^2; the reverse step's 11 N^2: kernels/costs.py:wkv6_backward_cost),
// 7.65 GFLOP, 114 us; the bytes, r, k, v, w and do read and dr, dk, dv, dw
// written once, dsT read, 159 MB, 48 us.  This kernel does more: it walks
// each chunk's states a second time (another ~3 N^2 a step, 1.41 GFLOP),
// writes and reads 268 MB of checkpoints, and writes ds0 even without s0
// (8 MB).  A block of 512 threads holds C states of its kCols columns in
// registers (64 floats; 128 registers a thread), so one block fits an SM
// and the block's dependent chains (a step's FMA chains and butterflies,
// the chunk's barriers) are hidden by its own 16 warps only: a first
// kernel, right and simple, latency-bound; its time stands beside the
// bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// must match BACKWARD_COLS and BACKWARD_CHUNK in kernels/rwkv6/kernel.py
// (the library reports them, and the wrapper refuses one built with others)
constexpr int kCols = 8;   // columns of the state a thread owns
constexpr int kChunk = 8;  // steps between checkpoints (states in registers)
constexpr int kDuThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The block's shape and its dynamic shared memory, in floats: a staged
// chunk (per step k, w, v, r, do: N each), the chunk's bonuses and v.do
// (C each), the warps' partial dv (C x W x N), the rows' dr, dk, dw (C x 3
// x N) and u (N).
template <int N>
struct Shape {
  static constexpr int C = kChunk;
  static constexpr int CG = N / kCols;      // threads a row
  static constexpr int kThreads = N * CG;
  static constexpr int RW = 32 / CG;        // rows a warp
  static constexpr int W = kThreads / 32;   // warps a block
  static constexpr int kStep = 5 * N;       // staged floats a step
  static constexpr int kBon = C * kStep;
  static constexpr int kVdo = kBon + C;
  static constexpr int kPart = kVdo + C;
  static constexpr int kRows = kPart + C * W * N;
  static constexpr int kU = kRows + 3 * C * N;
  static constexpr int kFloats = kU + N;
  static constexpr int kBytes = kFloats * 4;
  static_assert(N % kCols == 0 && CG >= 1 && CG <= 32 && 32 % CG == 0,
                "a row's threads must be lanes of one warp");
  static_assert(kThreads % 32 == 0, "a block must be whole warps");
  static_assert(2 * C <= kThreads, "a thread a step's bonus and v.do");
};

// A thread's share of a chunk's staging: elements e = tid + q NT of the
// first A of (k, w, v, r, do) over steps [t0, t0 + cs), step e / (A N),
// array (e / N) % A, index e % N.  fetch loads them as f32 into registers,
// put stores them into shared memory (step s's array a at sm[s 5N + a N]):
// a chunk's loads are in flight while the chunk before it is computed.
template <int A, int N, int NT>
struct Stage {
  static constexpr int kElems = kChunk * A * N;
  static constexpr int kPer = (kElems + NT - 1) / NT;

  template <typename T>
  __device__ __forceinline__ static void fetch(
      float (&x)[kPer], const T* k, const T* w, const T* v, const T* r,
      const T* d, long long base, long long hn, long long t0, int cs,
      int tid) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = tid + q * NT, s = e / (A * N), a = (e / N) % A;
      const int n = e % N;
      if (e < kElems && s < cs) {
        const T* src = a == 0 ? k : a == 1 ? w : a == 2 ? v : a == 3 ? r : d;
        x[q] = to_f32(src[base + (t0 + s) * hn + n]);
      }
    }
  }

  __device__ __forceinline__ static void put(const float (&x)[kPer],
                                             float* sm, int cs, int tid) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = tid + q * NT, s = e / (A * N), a = (e / N) % A;
      if (e < kElems && s < cs) sm[s * 5 * N + a * N + e % N] = x[q];
    }
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(Shape<N>::kThreads, 1)
    wkv6_backward_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ w,
                         const T* __restrict__ u, const float* s0,
                         const T* __restrict__ dout, const float* dsT,
                         T* __restrict__ dr, T* __restrict__ dk,
                         T* __restrict__ dv, T* __restrict__ dw,
                         float* __restrict__ ds0, float* __restrict__ ckpt,
                         float* __restrict__ du_part, long long steps,
                         long long H) {
  using L = Shape<N>;
  constexpr int C = L::C, CG = L::CG, W = L::W, NT = L::kThreads;
  extern __shared__ __align__(16) float sm[];
  float* bon = sm + L::kBon;
  float* vdo = sm + L::kVdo;
  float* part = sm + L::kPart;
  float* rows = sm + L::kRows;
  float* us = sm + L::kU;
  using Fwd = Stage<3, N, NT>;
  using Rev = Stage<5, N, NT>;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / CG, cg = tid % CG, j0 = cg * kCols;
  const long long bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long hn = H * N;                       // elements a step
  const long long base = (b * steps * H + h) * N;   // element (b, 0, h, 0)
  const long long nchunks = (steps + C - 1) / C;
  // this thread's kCols state elements in (B, H, N, N) and in its block's
  // checkpoint c
  const long long sel = bh * N * N + i * N + j0;
  float* ck = ckpt + bh * nchunks * N * N + i * N + j0;
  auto steps_of = [&](long long t0) {
    return static_cast<int>(steps - t0 < C ? steps - t0 : C);
  };
  for (int e = tid; e < N; e += NT) us[e] = to_f32(u[h * N + e]);

  // 1. forward: the checkpoints
  float S[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) S[q] = s0 ? s0[sel + q] : 0.f;
  float fx[Fwd::kPer];
  Fwd::fetch(fx, k, w, v, r, dout, base, hn, 0, steps_of(0), tid);
  for (long long c = 0; c < nchunks; ++c) {
    const long long t0 = c * C;
    const int cs = steps_of(t0);
#pragma unroll
    for (int q = 0; q < kCols; ++q) ck[c * N * N + q] = S[q];
    __syncthreads();                  // the last chunk's staging read
    Fwd::put(fx, sm, cs, tid);
    __syncthreads();
    if (c + 1 < nchunks) {
      Fwd::fetch(fx, k, w, v, r, dout, base, hn, t0 + C, steps_of(t0 + C),
                 tid);
    }
    for (int s = 0; s < cs; ++s) {
      const float* st = sm + s * L::kStep;
      const float kk = st[i], ww = st[N + i];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        S[q] = __fadd_rn(__fmul_rn(ww, S[q]),
                         __fmul_rn(kk, st[2 * N + j0 + q]));
      }
    }
  }

  // 2. reverse
  float G[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) G[q] = dsT ? dsT[sel + q] : 0.f;
  const float ui = us[i];
  float du_acc = 0.f;
  float rx[Rev::kPer];
  Rev::fetch(rx, k, w, v, r, dout, base, hn, (nchunks - 1) * C,
             steps_of((nchunks - 1) * C), tid);
  for (long long c = nchunks - 1; c >= 0; --c) {
    const long long t0 = c * C;
    const int cs = steps_of(t0);
    __syncthreads();                  // the last chunk's outputs read
    Rev::put(rx, sm, cs, tid);
    __syncthreads();
    if (c > 0) Rev::fetch(rx, k, w, v, r, dout, base, hn, t0 - C, C, tid);
    // the chunk's bonuses and v.do, each summed in order from its first
    // term
    if (tid < 2 * C && tid % C < cs) {
      const int s = tid % C;
      const float* st = sm + s * L::kStep;
      float p;
      if (tid < C) {                  // b_t = sum_n (r u) k
        p = __fmul_rn(__fmul_rn(st[3 * N], us[0]), st[0]);
#pragma unroll
        for (int n = 1; n < N; ++n) {
          p = __fadd_rn(p, __fmul_rn(__fmul_rn(st[3 * N + n], us[n]),
                                     st[n]));
        }
        bon[s] = p;
      } else {                        // v_t . do_t
        p = __fmul_rn(st[2 * N], st[4 * N]);
#pragma unroll
        for (int n = 1; n < N; ++n) {
          p = __fadd_rn(p, __fmul_rn(st[2 * N + n], st[4 * N + n]));
        }
        vdo[s] = p;
      }
    }
    // the chunk's states S_{t-1}, walked again from its checkpoint
    float Sc[C][kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) Sc[0][q] = ck[c * N * N + q];
#pragma unroll
    for (int s = 1; s < C; ++s) {
      if (s < cs) {
        const float* st = sm + (s - 1) * L::kStep;
        const float kk = st[i], ww = st[N + i];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          Sc[s][q] = __fadd_rn(__fmul_rn(ww, Sc[s - 1][q]),
                               __fmul_rn(kk, st[2 * N + j0 + q]));
        }
      }
    }
    __syncthreads();                  // the bonuses and v.do written
#pragma unroll
    for (int s = C - 1; s >= 0; --s) {
      if (s < cs) {
        const float* st = sm + s * L::kStep;
        const float kk = st[i], ww = st[N + i], rr = st[3 * N + i];
        const float vd = vdo[s];
        float vq[kCols], dq[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          vq[q] = st[2 * N + j0 + q];
          dq[q] = st[4 * N + j0 + q];
        }
        float ar = 0.f, ak = 0.f, aw = 0.f;
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          ar = __fmaf_rn(Sc[s][q], dq[q], ar);
          ak = __fmaf_rn(G[q], vq[q], ak);
          aw = __fmaf_rn(G[q], Sc[s][q], aw);
        }
#pragma unroll
        for (int m = 1; m < CG; m <<= 1) {
          ar = __fadd_rn(ar, __shfl_xor_sync(0xffffffffu, ar, m));
          ak = __fadd_rn(ak, __shfl_xor_sync(0xffffffffu, ak, m));
          aw = __fadd_rn(aw, __shfl_xor_sync(0xffffffffu, aw, m));
        }
        float p[kCols];
#pragma unroll
        for (int q = 0; q < kCols; ++q) p[q] = __fmul_rn(G[q], kk);
#pragma unroll
        for (int m = CG; m < 32; m <<= 1) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            p[q] = __fadd_rn(p[q], __shfl_xor_sync(0xffffffffu, p[q], m));
          }
        }
        if (lane < CG) {
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            part[(s * W + warp) * N + j0 + q] = p[q];
          }
        }
        if (cg == 0) {
          float* rw = rows + s * 3 * N;
          rw[i] = __fadd_rn(ar, __fmul_rn(__fmul_rn(ui, kk), vd));
          rw[N + i] = __fadd_rn(ak, __fmul_rn(__fmul_rn(ui, rr), vd));
          rw[2 * N + i] = aw;
        }
        du_acc = __fadd_rn(du_acc, __fmul_rn(__fmul_rn(rr, kk), vd));
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          G[q] = __fadd_rn(__fmul_rn(ww, G[q]), __fmul_rn(rr, dq[q]));
        }
      }
    }
    __syncthreads();                  // the chunk's partials written
    // the chunk's outputs: dv's warps added in order, plus b_t do_t
    for (int e = tid; e < cs * N; e += NT) {
      const int s = e / N, n = e % N;
      const long long off = base + (t0 + s) * hn + n;
      float acc = part[s * W * N + n];
#pragma unroll
      for (int q = 1; q < W; ++q) {
        acc = __fadd_rn(acc, part[(s * W + q) * N + n]);
      }
      store(dv + off,
            __fadd_rn(acc, __fmul_rn(bon[s], sm[s * L::kStep + 4 * N + n])));
      store(dr + off, rows[s * 3 * N + n]);
      store(dk + off, rows[s * 3 * N + N + n]);
      store(dw + off, rows[s * 3 * N + 2 * N + n]);
    }
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) ds0[sel + q] = G[q];
  if (cg == 0) du_part[bh * N + i] = du_acc;
}

// du[h][n] = sum over b of du_part[b][h][n], in order from b = 0
template <typename T>
__global__ void __launch_bounds__(kDuThreads)
    wkv6_du_kernel(const float* __restrict__ du_part, T* __restrict__ du,
                   long long B, long long hn) {
  const long long e = (long long)blockIdx.x * kDuThreads + threadIdx.x;
  if (e >= hn) return;
  float acc = du_part[e];
  for (long long b = 1; b < B; ++b) acc = __fadd_rn(acc, du_part[b * hn + e]);
  store(du + e, acc);
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* dout, const void* dsT,
           void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
           void* ckpt, void* du_part, long long B, long long steps,
           long long H, cudaStream_t stream) {
  using L = Shape<N>;
  if (L::kBytes > 48 * 1024) {
    static bool raised = false;      // once per instantiation
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          wkv6_backward_kernel<T, N>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  wkv6_backward_kernel<T, N>
      <<<static_cast<unsigned>(B * H), L::kThreads, L::kBytes, stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(w),
          static_cast<const T*>(u), static_cast<const float*>(s0),
          static_cast<const T*>(dout), static_cast<const float*>(dsT),
          static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
          static_cast<T*>(dw), static_cast<float*>(ds0),
          static_cast<float*>(ckpt), static_cast<float*>(du_part), steps, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long hn = H * N;
  wkv6_du_kernel<T>
      <<<static_cast<unsigned>((hn + kDuThreads - 1) / kDuThreads),
         kDuThreads, 0, stream>>>(static_cast<const float*>(du_part),
                                  static_cast<T*>(du), B, hn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, const void* dout, const void* dsT,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* ckpt, void* du_part, long long B, long long steps,
             long long H, long long N, cudaStream_t stream) {
  if (N == 16)
    return launch<T, 16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du,
                         ds0, ckpt, du_part, B, steps, H, stream);
  if (N == 32)
    return launch<T, 32>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du,
                         ds0, ckpt, du_part, B, steps, H, stream);
  if (N == 64)
    return launch<T, 64>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du,
                         ds0, ckpt, du_part, B, steps, H, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The constants this library was built with: kCols and kChunk.  The wrapper
// refuses a library whose constants differ from its own.
void repro_wkv6_backward_constants(int* out) {
  out[0] = kCols;
  out[1] = kChunk;
}

// Each entry launches the backward kernel and the du kernel on `stream` and
// returns cudaGetLastError() (0 when both launches were accepted).  s0 and
// dsT may be null (zeros); ds0 is written either way.  ckpt is scratch of
// (B, H, ceil(T / kChunk), N, N) f32 and du_part of (B, H, N) f32.  The
// wrapper has checked shapes, dtypes, contiguity, T >= 1 and N.
int repro_wkv6_backward_bf16(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             const void* dout, const void* dsT, void* dr,
                             void* dk, void* dv, void* dw, void* du,
                             void* ds0, void* ckpt, void* du_part,
                             long long B, long long T, long long H,
                             long long N, void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv,
                                 dw, du, ds0, ckpt, du_part, B, T, H, N,
                                 static_cast<cudaStream_t>(stream));
}

int repro_wkv6_backward_f32(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            const void* dout, const void* dsT, void* dr,
                            void* dk, void* dv, void* dw, void* du, void* ds0,
                            void* ckpt, void* du_part, long long B,
                            long long T, long long H, long long N,
                            void* stream) {
  return dispatch<float>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du,
                         ds0, ckpt, du_part, B, T, H, N,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
