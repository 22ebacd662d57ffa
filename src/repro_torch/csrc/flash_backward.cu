// Backward of causal GQA flash attention for Hopper (sm_90a), with a plain
// C interface.
//
// No TPU kernel precedes it: the JAX package has no backward kernel (no
// `custom_vjp` anywhere); its train step differentiates `_flash_xla`
// (src/repro/kernels/flash_attention/ops.py) with XLA.  This kernel computes
// that gradient for the training form of the forward: causal, q_start 0,
// Sq = Skv = S, with or without a local window W (keys at or before q - W
// masked).  Given q (B,S,H,D), k and v (B,S,KV,D), the forward's output o
// (B,S,H,D) and the output's gradient dO (B,S,H,D), with P = softmax(scale
// * q k^T) under the mask, it returns
//   dV = P^T dO,  dS = P * (dO v^T - rowsum(dO * o)),
//   dQ = scale * dS k,  dK = scale * dS^T q,
// summed over the G = H / KV query heads that share a KV head.  Inputs and
// outputs are bf16 or f32 (all one dtype); every sum is f32.  D = Dv = 64
// (llama3.2-1b's heads, granite-moe-3b-a800m's), 128 (starcoder2-7b's,
// granite-20b's, chameleon-34b's) or 256 (gemma-7b's, recurrentgemma-2b's);
// the wrapper refuses other pairs.
//
// Design: three kernels, launched in order by one entry, no atomics (a
// replay gives the same bits):
//   * setup: one block per (batch, head, tile of 32 query rows) recomputes
//     each row's log-sum-exp over its live keys (an online max and sum over
//     32-key tiles) and D = rowsum(dO * o), into f32 scratch (B, H, S).
//     The forward kernels, which serving captures in CUDA graphs, keep
//     their outputs as they are;
//   * dK/dV: one block per (batch, KV head, tile of 32 keys, 64 columns)
//     keeps dK and dV of its keys and columns in registers (a 4 x 4 patch
//     of each per thread) and loops over the G heads and the live query
//     tiles at or after its keys: S and dO v^T as 32 x 32 tiles over the
//     full D (a 2 x 4 patch per thread), P and dS into shared memory, then
//     dV += P^T dO and dK += dS^T q on its columns;
//   * dQ: one block per (batch, head, tile of 32 query rows, 64 columns)
//     loops over the live key tiles at or before its rows and sums dQ += dS
//     k on its columns in registers.
// At D 128 and 256 the two or four column blocks of a tile each recompute
// S and dP over the full D: the accumulators keep the registers of D 64, and the tiles
// (f32, full D) fit a block's shared memory.  The window bounds each
// block's tiles (a dQ block starts at the tile of its first row's first
// live key, a dK/dV block ends at the tile of the last query whose window
// reaches its last key); masks are per element.
// Tiles are staged in shared memory as f32 (row-major, or transposed where
// a product reads them by column), rows past S as zeros; the products are
// CUDA-core FMAs.
//
// What bounds it on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 dense):
// at llama3.2-1b's training shape (B 8, S 256, H 32, KV 8, D 64, bf16) one
// layer's backward must read q, k, v, o and dO and write dq, dk and dv,
// 41.9 MB, 12.5 us; its five products over the 32,896 causal (query, key)
// pairs of each head are 5.4 GFLOP, 5.4 us on the tensor cores.  So bytes
// bound it.  This kernel is far from that: it recomputes the scores three
// times (setup, dK/dV, dQ; at D 256 nine), and its FMAs run on the CUDA
// cores, not the tensor cores: it keeps the f32 calls, whose 1e-4 check
// TF32 would miss, and flash_backward_sm90.cu takes bf16.  PERF.md gives
// its time beside the bound and beside SDPA's backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kT = 32;          // query rows per tile, and keys per tile
constexpr int kC = 64;          // columns of a block's dK, dV or dQ
constexpr int kLt = kT + 4;     // row stride of a transposed tile, P and dS
constexpr unsigned kFull = 0xffffffffu;
// row stride (floats) of a row-major tile of D columns
template <int kD>
__host__ __device__ constexpr int ld() { return kD + 4; }

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
  long long B, S, H, KV, cols;
  long long window; // keys at or before q - window masked (>= 1)
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
// base + r * stride (columns c0 .. c0 + kW - 1 of it), into dst[r][d] (row
// stride kW + 4) as f32; rows at or past `rows` are zeros.
template <int kW, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* base,
                                          long long row0, long long rows,
                                          long long stride, int c0 = 0) {
  constexpr int kVec = Vec<T>::n, kVpr = kW / kVec, kL = ld<kW>();
  for (int i = threadIdx.x; i < kT * kVpr; i += kThreads) {
    const int r = i / kVpr, c = i - r * kVpr;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows)
      u = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride + c0 +
                                          c * kVec);
    float x[kVec];
    unpack(u, x, T());
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + r * kL + c * kVec + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
}

// The same rows (all kD columns) transposed: dst[d][r] (row stride kLt).
// Neighbouring threads take neighbouring rows, so the scalar stores of a
// warp fall in distinct banks.
template <int kD, typename T>
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
// 32 x 32 product of a row-major tile and a transposed one, over kD
template <int kD>
__device__ __forceinline__ void tile_product(const float* A, const float* Bt,
                                             int ti, int tj,
                                             float (&s)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  const float* a0 = A + (2 * ti) * ld<kD>();
  const float* a1 = a0 + ld<kD>();
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

// whether key j is live for query i: at or before it, inside its window
__device__ __forceinline__ bool live(long long i, long long j, long long S,
                                     long long W) {
  return i < S && j <= i && j > i - W;
}

// the first key tile (its first key) of query rows i0 ..: the tile holding
// the first row's first live key
__device__ __forceinline__ long long first_key_tile(long long i0,
                                                    long long W) {
  const long long k = i0 - W + 1 > 0 ? i0 - W + 1 : 0;
  return k / kT * kT;
}

template <int kD>
constexpr size_t setup_smem() {
  return sizeof(float) * (kT * ld<kD>() + kD * kLt);
}

// The log-sum-exp of each query row's scaled scores over its live keys,
// and D = rowsum(dO * o).  Grid (query tiles, B * H).
template <int kD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_setup_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // kT x ld<kD>
  float* Kt = Qs + kT * ld<kD>();    // kD x kLt
  const long long S = p.S, H = p.H, KV = p.KV, G = H / KV, W = p.window;
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
      float x = to_f32(orow[lane]) * to_f32(drow[lane]);
#pragma unroll
      for (int d = 32; d < kD; d += 32)
        x += to_f32(orow[lane + d]) * to_f32(drow[lane + d]);
      x = warp_sum(x);
      if (lane == 0) delta[i] = x;
    }
  }

  load_rows<kD>(Qs, q, i0, S, H * kD);
  const int ti = tid >> 3, tj = tid & 7;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const long long i_last = (i0 + kT < S ? i0 + kT : S) - 1;
  for (long long j0 = first_key_tile(i0, W); j0 <= i_last; j0 += kT) {
    __syncthreads();
    load_cols<kD>(Kt, k, j0, S, KV * kD);
    __syncthreads();
    float s[2][4];
    tile_product<kD>(Qs, Kt, ti, tj, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = i0 + 2 * ti + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long j = j0 + 4 * tj + c;
        s[r][c] = live(i, j, S, W) ? s[r][c] * p.scale : -INFINITY;
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
// s and dP = dO v^T; dead pairs (after a row's diagonal, at or before its
// window) and rows past S get 0.
__device__ __forceinline__ void probs(float (&s)[2][4], float (&dp)[2][4],
                                      const float* lse_s, const float* del_s,
                                      long long i0, long long j0,
                                      long long S, long long W, float scale,
                                      int ti, int tj) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = i0 + 2 * ti + r;
    const float li = lse_s[2 * ti + r], di = del_s[2 * ti + r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long j = j0 + 4 * tj + c;
      const float pr = live(i, j, S, W) ? expf(s[r][c] * scale - li) : 0.f;
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

template <int kD>
constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (2 * kD * kLt + 2 * kT * ld<kD>() + 2 * kT * kLt + 2 * kT);
}
template <int kD>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kT * ld<kD>() + 2 * kD * kLt + kT * ld<kC>() +
                          kT * kLt + 2 * kT);
}
static_assert(dq_smem<128>() <= 232448 && dkdv_smem<128>() <= 232448 &&
                  dq_smem<256>() <= 232448 && dkdv_smem<256>() <= 232448,
              "a block's shared memory");

// dK and dV of 32 keys and 64 columns of one KV head.  Grid (key tiles,
// B * KV * column blocks).
template <int kD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(Params p) {
  constexpr int kL = ld<kD>();
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                  // kD x kLt
  float* Vt = Kt + kD * kLt;         // kD x kLt
  float* Qs = Vt + kD * kLt;         // kT x kL
  float* dOs = Qs + kT * kL;         // kT x kL
  float* Ps = dOs + kT * kL;         // kT x kLt
  float* dSs = Ps + kT * kLt;        // kT x kLt
  float* lse_s = dSs + kT * kLt;     // kT
  float* del_s = lse_s + kT;         // kT

  const long long S = p.S, H = p.H, KV = p.KV, G = H / KV, W = p.window;
  const long long bk = blockIdx.y / p.cols;
  const int c0 = (int)(blockIdx.y - bk * p.cols) * kC;
  const long long b = bk / KV, kvh = bk % KV;
  const long long j0 = (long long)blockIdx.x * kT;
  const int tid = threadIdx.x;
  const T* kb = static_cast<const T*>(p.k) + (b * S * KV + kvh) * kD;
  const T* vb = static_cast<const T*>(p.v) + (b * S * KV + kvh) * kD;
  load_cols<kD>(Kt, kb, j0, S, KV * kD);
  load_cols<kD>(Vt, vb, j0, S, KV * kD);

  const int ti = tid >> 3, tj = tid & 7;    // score patch: rows, keys
  const int tk = tid >> 4, td = tid & 15;   // dK/dV patch: keys, dims
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[a][c] = dv[a][c] = 0.f;

  // the query tiles at or after the block's keys (the causal mask) whose
  // last row's window reaches its last key
  const long long i_end = j0 + kT - 1 + W - 1 < S ? j0 + kT - 1 + W : S;
  for (long long g = 0; g < G; ++g) {
    const long long h = kvh * G + g;
    const T* qb = static_cast<const T*>(p.q) + (b * S * H + h) * kD;
    const T* db = static_cast<const T*>(p.dout) + (b * S * H + h) * kD;
    const float* lse = p.lse + (b * H + h) * S;
    const float* delta = p.delta + (b * H + h) * S;
    for (long long i0 = j0; i0 < i_end; i0 += kT) {
      __syncthreads();
      load_rows<kD>(Qs, qb, i0, S, H * kD);
      load_rows<kD>(dOs, db, i0, S, H * kD);
      load_row_stats(lse_s, del_s, lse, delta, i0, S);
      __syncthreads();
      float s[2][4], dp[2][4];
      tile_product<kD>(Qs, Kt, ti, tj, s);
      tile_product<kD>(dOs, Vt, ti, tj, dp);
      probs(s, dp, lse_s, del_s, i0, j0, S, W, p.scale, ti, tj);
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
        const float4 ov = *reinterpret_cast<const float4*>(
            dOs + i * kL + c0 + 4 * td);
        const float4 qv = *reinterpret_cast<const float4*>(
            Qs + i * kL + c0 + 4 * td);
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

  T* dkb = static_cast<T*>(p.dk) + (b * S * KV + kvh) * kD + c0;
  T* dvb = static_cast<T*>(p.dv) + (b * S * KV + kvh) * kD + c0;
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

// dQ of 32 query rows and 64 columns of one head.  Grid (query tiles, B *
// H * column blocks).
template <int kD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Params p) {
  constexpr int kL = ld<kD>(), kLc = ld<kC>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // kT x kL
  float* dOs = Qs + kT * kL;         // kT x kL
  float* Kt = dOs + kT * kL;         // kD x kLt
  float* Vt = Kt + kD * kLt;         // kD x kLt
  float* Ks = Vt + kD * kLt;         // kT x kLc: the block's columns of k
  float* dSs = Ks + kT * kLc;        // kT x kLt
  float* lse_s = dSs + kT * kLt;     // kT
  float* del_s = lse_s + kT;         // kT

  const long long S = p.S, H = p.H, KV = p.KV, G = H / KV, W = p.window;
  const long long bh = blockIdx.y / p.cols;
  const int c0 = (int)(blockIdx.y - bh * p.cols) * kC;
  const long long b = bh / H, h = bh % H, kvh = h / G;
  const long long i0 = (long long)blockIdx.x * kT;
  const int tid = threadIdx.x;
  const T* kb = static_cast<const T*>(p.k) + (b * S * KV + kvh) * kD;
  const T* vb = static_cast<const T*>(p.v) + (b * S * KV + kvh) * kD;
  load_rows<kD>(Qs, static_cast<const T*>(p.q) + (b * S * H + h) * kD, i0,
                S, H * kD);
  load_rows<kD>(dOs, static_cast<const T*>(p.dout) + (b * S * H + h) * kD,
                i0, S, H * kD);
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
  for (long long j0 = first_key_tile(i0, W); j0 <= i_last; j0 += kT) {
    __syncthreads();
    load_cols<kD>(Kt, kb, j0, S, KV * kD);
    load_cols<kD>(Vt, vb, j0, S, KV * kD);
    load_rows<kC>(Ks, kb, j0, S, KV * kD, c0);
    __syncthreads();
    float s[2][4], dp[2][4];
    tile_product<kD>(Qs, Kt, ti, tj, s);
    tile_product<kD>(dOs, Vt, ti, tj, dp);
    probs(s, dp, lse_s, del_s, i0, j0, S, W, p.scale, ti, tj);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float4*>(dSs + (2 * ti + r) * kLt + 4 * tj) =
          make_float4(dp[r][0], dp[r][1], dp[r][2], dp[r][3]);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + j * kLc +
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

  T* dqb = static_cast<T*>(p.dq) + (b * S * H + h) * kD + c0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long i = i0 + 4 * tq + a;
    if (i >= S) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store(dqb + i * H * kD + 4 * td + c, dq[a][c] * p.scale);
  }
}

template <int kD, typename T>
int run(Params p, cudaStream_t stream) {
  p.cols = kD / kC;
  cudaError_t e = cudaFuncSetAttribute(
      bwd_setup_kernel<kD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)setup_smem<kD>());
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dkdv_kernel<kD, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dkdv_smem<kD>());
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dq_kernel<kD, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dq_smem<kD>());
  if (e != cudaSuccess) return (int)e;
  const unsigned tiles = (unsigned)((p.S + kT - 1) / kT);
  bwd_setup_kernel<kD, T><<<dim3(tiles, (unsigned)(p.B * p.H)), kThreads,
                            setup_smem<kD>(), stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv_kernel<kD, T><<<dim3(tiles, (unsigned)(p.B * p.KV * p.cols)),
                           kThreads, dkdv_smem<kD>(), stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq_kernel<kD, T><<<dim3(tiles, (unsigned)(p.B * p.H * p.cols)),
                         kThreads, dq_smem<kD>(), stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run_d(const Params& p, long long D, cudaStream_t stream) {
  if (D == 64) return run<64, T>(p, stream);
  return D == 128 ? run<128, T>(p, stream) : run<256, T>(p, stream);
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns cudaGetLastError()
// (0 when every launch was accepted).  Sizes are elements; window <= 0
// means none.  The wrapper has checked shapes (D = Dv, 64, 128 or 256),
// dtypes, contiguity, alignment and S > 0, and allocated dq, dk, dv and the
// f32 scratch lse and delta (B * H * S each).
int repro_flash_backward(int is_bf16, const void* q, const void* k,
                         const void* v, const void* o, const void* dout,
                         void* dq, void* dk, void* dv, void* lse,
                         void* delta, long long B, long long S, long long H,
                         long long KV, long long D, long long window,
                         float scale, void* stream) {
  if (D != 64 && D != 128 && D != 256) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = B; p.S = S; p.H = H; p.KV = KV;
  p.window = window >= 1 && window < S ? window : S;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run_d<__nv_bfloat16>(p, D, s) : run_d<float>(p, D, s);
}

}  // extern "C"
