// Backward of causal GQA flash attention for Hopper (sm_90a), with a plain
// C interface.
//
// No TPU kernel precedes it: the JAX package has no backward kernel (no
// `custom_vjp` anywhere); its train step differentiates `_flash_xla`
// (src/repro/kernels/flash_attention/ops.py) with XLA.  This kernel computes
// that gradient for the training form of the forward: causal, q_start 0,
// Sq = Skv = S, no window.  Given q (B,S,H,D), k and v (B,S,KV,D), the
// forward's output o (B,S,H,D) and the output's gradient dO (B,S,H,D), with
// P = softmax(scale * q k^T) under the causal mask, it returns
//   dV = P^T dO,  dS = P * (dO v^T - rowsum(dO * o)),
//   dQ = scale * dS k,  dK = scale * dS^T q,
// summed over the G = H / KV query heads that share a KV head.  Inputs and
// outputs are bf16 or f32 (all one dtype); every sum is f32.  D = Dv = 64
// only (llama3.2-1b's heads); the wrapper refuses other pairs and windows.
//
// Design: three kernels, launched in order by one entry, no atomics (a
// replay gives the same bits):
//   * setup: one block per (batch, head, tile of 32 query rows) recomputes
//     each row's log-sum-exp over its live keys (an online max and sum over
//     32-key tiles) and D = rowsum(dO * o), into f32 scratch (B, H, S).
//     The forward kernels, which serving captures in CUDA graphs, keep
//     their outputs as they are;
//   * dK/dV: one block per (batch, KV head, tile of 32 keys) keeps dK and
//     dV of its keys in registers (a 4 x 4 patch of each per thread) and
//     loops over the G heads and the query tiles at or after its keys:
//     S and dO v^T as 32 x 32 tiles (a 2 x 4 patch per thread), P and dS
//     into shared memory, then dV += P^T dO and dK += dS^T q;
//   * dQ: one block per (batch, head, tile of 32 query rows) loops over the
//     key tiles at or before its rows and sums dQ += dS k in registers.
// Tiles are staged in shared memory as f32 (row-major, or transposed where
// a product reads them by column), rows past S as zeros; the products are
// CUDA-core FMAs.
//
// What bounds it on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 dense):
// at llama3.2-1b's training shape (B 8, S 256, H 32, KV 8, D 64, bf16) one
// layer's backward must read q, k, v, o and dO and write dq, dk and dv,
// 41.9 MB, 12.5 us; its five products over the 32,896 causal (query, key)
// pairs of each head are 5.4 GFLOP, 5.4 us on the tensor cores.  So bytes
// bound it.  This first kernel is far from that: it recomputes the scores
// three times (setup, dK/dV, dQ), and its FMAs run on the CUDA cores, not
// the tensor cores (`mma.sync` or `wgmma`, and TMA, are a later PR's work).
// PERF.md gives its time beside the bound and beside SDPA's backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 32;          // query rows per tile, and keys per tile
constexpr int kD = 64;          // head dim of q, k and v
constexpr int kLd = kD + 4;     // row stride (floats) of a row-major tile
constexpr int kLt = kT + 4;     // row stride of a transposed tile, P and dS
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;       // (B, H, S)
  float* delta;     // (B, H, S)
  long long B, S, H, KV;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16-byte vectors of T: rows move from device memory in these
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& u, float* x, float) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = f[e];
}
__device__ __forceinline__ void unpack(const uint4& u, float* x,
                                       __nv_bfloat16) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// max and sum over the 8 lanes of a group (lanes 8g .. 8g + 7)
__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows row0 .. row0 + kT - 1 of a (rows x kD) matrix whose row r starts at
// base + r * stride, into dst[r][d] (row stride kLd) as f32; rows at or
// past `rows` are zeros.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long row0, long long rows,
                                          long long stride) {
  constexpr int kVec = Vec<T>::n, kVpr = kD / kVec;
  for (int i = threadIdx.x; i < kT * kVpr; i += kThreads) {
    const int r = i / kVpr, c = i - r * kVpr;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      u = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride +
                                          c * kVec);
    float x[kVec];
    unpack(u, x, T());
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + r * kLd + c * kVec + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
}

// The same rows transposed: dst[d][r] (row stride kLt).  Neighbouring
// threads take neighbouring rows, so the scalar stores of a warp fall in
// distinct banks.
template <typename T>
__device__ __forceinline__ void load_cols(float* dst, const T* base,
                                          long long row0, long long rows,
                                          long long stride) {
  constexpr int kVec = Vec<T>::n, kVpr = kD / kVec;
  for (int i = threadIdx.x; i < kT * kVpr; i += kThreads) {
    const int r = i % kT, c = i / kT;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      u = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride +
                                          c * kVec);
    float x[kVec];
    unpack(u, x, T());
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[(c * kVec + e) * kLt + r] = x[e];
  }
}

// s[r][c] = sum_d A[2 ti + r][d] * Bt[d][4 tj + c]: a 2 x 4 patch of the
// 32 x 32 product of a row-major tile and a transposed one.
__device__ __forceinline__ void tile_product(const float* A, const float* Bt,
                                             int ti, int tj,
                                             float (&s)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  const float* a0 = A + (2 * ti) * kLd;
  const float* a1 = a0 + kLd;
#pragma unroll 8
  for (int d = 0; d < kD; ++d) {
    const float x0 = a0[d], x1 = a1[d];
    const float4 b = *reinterpret_cast<const float4*>(Bt + d * kLt + 4 * tj);
    s[0][0] = fmaf(x0, b.x, s[0][0]);
    s[0][1] = fmaf(x0, b.y, s[0][1]);
    s[0][2] = fmaf(x0, b.z, s[0][2]);
    s[0][3] = fmaf(x0, b.w, s[0][3]);
    s[1][0] = fmaf(x1, b.x, s[1][0]);
    s[1][1] = fmaf(x1, b.y, s[1][1]);
    s[1][2] = fmaf(x1, b.z, s[1][2]);
    s[1][3] = fmaf(x1, b.w, s[1][3]);
  }
}

// The log-sum-exp of each query row's scaled scores over its live keys,
// and D = rowsum(dO * o).  Grid (query tiles, B * H).
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_setup_kernel(Params p) {
  __shared__ __align__(16) float Qs[kT * kLd];
  __shared__ __align__(16) float Kt[kD * kLt];
  const long long S = p.S, H = p.H, KV = p.KV, G = H / KV;
  const long long b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const long long i0 = (long long)blockIdx.x * kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* q = static_cast<const T*>(p.q) + (b * S * H + h) * kD;
  const T* k = static_cast<const T*>(p.k) + (b * S * KV + kvh) * kD;
  const T* o = static_cast<const T*>(p.o) + (b * S * H + h) * kD;
  const T* dout = static_cast<const T*>(p.dout) + (b * S * H + h) * kD;
  float* lse = p.lse + (b * H + h) * S;
  float* delta = p.delta + (b * H + h) * S;

  // D: one warp a row (the branch is uniform over the warp)
  for (int r = warp; r < kT; r += kThreads / 32) {
    const long long i = i0 + r;
    if (i < S) {
      const T* orow = o + i * H * kD;
      const T* drow = dout + i * H * kD;
      float x = to_f32(orow[lane]) * to_f32(drow[lane]) +
                to_f32(orow[lane + 32]) * to_f32(drow[lane + 32]);
      x = warp_sum(x);
      if (lane == 0) delta[i] = x;
    }
  }

  load_rows(Qs, q, i0, S, H * kD);
  const int ti = tid >> 3, tj = tid & 7;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const long long i_last = (i0 + kT < S ? i0 + kT : S) - 1;
  for (long long j0 = 0; j0 <= i_last; j0 += kT) {
    __syncthreads();
    load_cols(Kt, k, j0, S, KV * kD);
    __syncthreads();
    float s[2][4];
    tile_product(Qs, Kt, ti, tj, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = i0 + 2 * ti + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long j = j0 + 4 * tj + c;
        s[r][c] = (i < S && j <= i) ? s[r][c] * p.scale : -INFINITY;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], group8_max(mx));
      float sum = 0.f;
      if (m_new != -INFINITY) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (s[r][c] != -INFINITY) sum += expf(s[r][c] - m_new);
      }
      sum = group8_sum(sum);
      if (m_new != -INFINITY) {
        const float corr = m[r] == -INFINITY ? 0.f : expf(m[r] - m_new);
        l[r] = l[r] * corr + sum;
        m[r] = m_new;
      }
    }
  }
  if (tj == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = i0 + 2 * ti + r;
      if (i < S) lse[i] = m[r] + logf(l[r]);
    }
  }
}

// P and dS of one 32 x 32 tile, a 2 x 4 patch per thread, from the scores
// s and dP = dO v^T; keys after a row's diagonal and rows past S get 0.
__device__ __forceinline__ void probs(float (&s)[2][4], float (&dp)[2][4],
                                      const float* lse_s, const float* del_s,
                                      long long i0, long long j0,
                                      long long S, float scale, int ti,
                                      int tj) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = i0 + 2 * ti + r;
    const float li = lse_s[2 * ti + r], di = del_s[2 * ti + r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long j = j0 + 4 * tj + c;
      const float pr = (i < S && j <= i) ? expf(s[r][c] * scale - li) : 0.f;
      s[r][c] = pr;
      dp[r][c] = pr * (dp[r][c] - di);
    }
  }
}

// lse and D of query rows i0 .. i0 + kT - 1 (0 past S) into shared memory
__device__ __forceinline__ void load_row_stats(float* lse_s, float* del_s,
                                               const float* lse,
                                               const float* delta,
                                               long long i0, long long S) {
  const int t = threadIdx.x;
  if (t < kT) {
    const long long i = i0 + t;
    lse_s[t] = i < S ? lse[i] : 0.f;
    del_s[t] = i < S ? delta[i] : 0.f;
  }
}

constexpr size_t kDkdvSmem =
    sizeof(float) * (2 * kD * kLt + 2 * kT * kLd + 2 * kT * kLt + 2 * kT);
constexpr size_t kDqSmem =
    sizeof(float) * (2 * kT * kLd + 2 * kD * kLt + kT * kLd + kT * kLt +
                     2 * kT);

// dK and dV of 32 keys of one KV head.  Grid (key tiles, B * KV).
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                  // kD x kLt
  float* Vt = Kt + kD * kLt;         // kD x kLt
  float* Qs = Vt + kD * kLt;         // kT x kLd
  float* dOs = Qs + kT * kLd;        // kT x kLd
  float* Ps = dOs + kT * kLd;        // kT x kLt
  float* dSs = Ps + kT * kLt;        // kT x kLt
  float* lse_s = dSs + kT * kLt;     // kT
  float* del_s = lse_s + kT;         // kT

  const long long S = p.S, H = p.H, KV = p.KV, G = H / KV;
  const long long b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const long long j0 = (long long)blockIdx.x * kT;
  const int tid = threadIdx.x;
  const T* kb = static_cast<const T*>(p.k) + (b * S * KV + kvh) * kD;
  const T* vb = static_cast<const T*>(p.v) + (b * S * KV + kvh) * kD;
  load_cols(Kt, kb, j0, S, KV * kD);
  load_cols(Vt, vb, j0, S, KV * kD);

  const int ti = tid >> 3, tj = tid & 7;    // score patch: rows, keys
  const int tk = tid >> 4, td = tid & 15;   // dK/dV patch: keys, dims
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[a][c] = dv[a][c] = 0.f;

  for (long long g = 0; g < G; ++g) {
    const long long h = kvh * G + g;
    const T* qb = static_cast<const T*>(p.q) + (b * S * H + h) * kD;
    const T* db = static_cast<const T*>(p.dout) + (b * S * H + h) * kD;
    const float* lse = p.lse + (b * H + h) * S;
    const float* delta = p.delta + (b * H + h) * S;
    // the query tiles at or after the block's keys (the causal mask)
    for (long long i0 = j0; i0 < S; i0 += kT) {
      __syncthreads();
      load_rows(Qs, qb, i0, S, H * kD);
      load_rows(dOs, db, i0, S, H * kD);
      load_row_stats(lse_s, del_s, lse, delta, i0, S);
      __syncthreads();
      float s[2][4], dp[2][4];
      tile_product(Qs, Kt, ti, tj, s);
      tile_product(dOs, Vt, ti, tj, dp);
      probs(s, dp, lse_s, del_s, i0, j0, S, p.scale, ti, tj);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float4*>(Ps + (2 * ti + r) * kLt + 4 * tj) =
            make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
        *reinterpret_cast<float4*>(dSs + (2 * ti + r) * kLt + 4 * tj) =
            make_float4(dp[r][0], dp[r][1], dp[r][2], dp[r][3]);
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kT; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + i * kLt +
                                                           4 * tk);
        const float4 sv = *reinterpret_cast<const float4*>(dSs + i * kLt +
                                                           4 * tk);
        const float4 ov = *reinterpret_cast<const float4*>(dOs + i * kLd +
                                                           4 * td);
        const float4 qv = *reinterpret_cast<const float4*>(Qs + i * kLd +
                                                           4 * td);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
        const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dv[a][c] = fmaf(pa[a], oa[c], dv[a][c]);
            dk[a][c] = fmaf(sa[a], qa[c], dk[a][c]);
          }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + (b * S * KV + kvh) * kD;
  T* dvb = static_cast<T*>(p.dv) + (b * S * KV + kvh) * kD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long j = j0 + 4 * tk + a;
    if (j >= S) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      store(dkb + j * KV * kD + 4 * td + c, dk[a][c] * p.scale);
      store(dvb + j * KV * kD + 4 * td + c, dv[a][c]);
    }
  }
}

// dQ of 32 query rows of one head.  Grid (query tiles, B * H).
template <typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // kT x kLd
  float* dOs = Qs + kT * kLd;        // kT x kLd
  float* Kt = dOs + kT * kLd;        // kD x kLt
  float* Vt = Kt + kD * kLt;         // kD x kLt
  float* Ks = Vt + kD * kLt;         // kT x kLd
  float* dSs = Ks + kT * kLd;        // kT x kLt
  float* lse_s = dSs + kT * kLt;     // kT
  float* del_s = lse_s + kT;         // kT

  const long long S = p.S, H = p.H, KV = p.KV, G = H / KV;
  const long long b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const long long i0 = (long long)blockIdx.x * kT;
  const int tid = threadIdx.x;
  const T* kb = static_cast<const T*>(p.k) + (b * S * KV + kvh) * kD;
  const T* vb = static_cast<const T*>(p.v) + (b * S * KV + kvh) * kD;
  load_rows(Qs, static_cast<const T*>(p.q) + (b * S * H + h) * kD, i0, S,
            H * kD);
  load_rows(dOs, static_cast<const T*>(p.dout) + (b * S * H + h) * kD, i0,
            S, H * kD);
  load_row_stats(lse_s, del_s, p.lse + (b * H + h) * S,
                 p.delta + (b * H + h) * S, i0, S);

  const int ti = tid >> 3, tj = tid & 7;    // score patch: rows, keys
  const int tq = tid >> 4, td = tid & 15;   // dQ patch: rows, dims
  float dq[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[a][c] = 0.f;

  const long long i_last = (i0 + kT < S ? i0 + kT : S) - 1;
  for (long long j0 = 0; j0 <= i_last; j0 += kT) {
    __syncthreads();
    load_cols(Kt, kb, j0, S, KV * kD);
    load_cols(Vt, vb, j0, S, KV * kD);
    load_rows(Ks, kb, j0, S, KV * kD);
    __syncthreads();
    float s[2][4], dp[2][4];
    tile_product(Qs, Kt, ti, tj, s);
    tile_product(dOs, Vt, ti, tj, dp);
    probs(s, dp, lse_s, del_s, i0, j0, S, p.scale, ti, tj);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float4*>(dSs + (2 * ti + r) * kLt + 4 * tj) =
          make_float4(dp[r][0], dp[r][1], dp[r][2], dp[r][3]);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + j * kLd +
                                                         4 * td);
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float sa = dSs[(4 * tq + a) * kLt + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) dq[a][c] = fmaf(sa, ka[c], dq[a][c]);
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq) + (b * S * H + h) * kD;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long i = i0 + 4 * tq + a;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store(dqb + i * H * kD + 4 * td + c, dq[a][c] * p.scale);
  }
}

template <typename T>
int run(const Params& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDkdvSmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dq_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kDqSmem);
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)((p.S + kT - 1) / kT);
  bwd_setup_kernel<T><<<dim3(tiles, (unsigned)(p.B * p.H)), kThreads, 0,
                        stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv_kernel<T><<<dim3(tiles, (unsigned)(p.B * p.KV)), kThreads,
                       kDkdvSmem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq_kernel<T><<<dim3(tiles, (unsigned)(p.B * p.H)), kThreads, kDqSmem,
                     stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns cudaGetLastError()
// (0 when every launch was accepted).  Sizes are elements; the wrapper has
// checked shapes (D = Dv = kD), dtypes, contiguity, alignment and S > 0,
// and allocated dq, dk, dv and the f32 scratch lse and delta (B * H * S
// each).
int repro_flash_backward(int is_bf16, const void* q, const void* k,
                         const void* v, const void* o, const void* dout,
                         void* dq, void* dk, void* dv, void* lse,
                         void* delta, long long B, long long S, long long H,
                         long long KV, long long D, float scale,
                         void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = B; p.S = S; p.H = H; p.KV = KV;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(p, s) : run<float>(p, s);
}

}  // extern "C"
