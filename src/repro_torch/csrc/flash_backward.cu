// Backward of GQA flash attention for Hopper (sm_90a), with a plain C
// interface.
//
// No TPU kernel precedes it: the JAX package has no backward kernel (no
// `custom_vjp` anywhere); its train step differentiates `_flash_xla`
// (src/repro/kernels/flash_attention/ops.py) with XLA.  This kernel computes
// that gradient for the training forms of the forward, q_start 0: causal,
// Sq = Skv = S, with or without a local window W (keys at or before q - W
// masked), or non-causal over every key, any Sq and Skv.  Given q
// (B,Sq,H,D), k (B,Skv,KV,D), v (B,Skv,KV,Dv), the forward's output o
// (B,Sq,H,Dv) and the output's gradient dO (B,Sq,H,Dv), with P =
// softmax(scale * q k^T) under the mask, it returns
//   dV = P^T dO,  dS = P * (dO v^T - rowsum(dO * o)),
//   dQ = scale * dS k,  dK = scale * dS^T q,
// summed over the G = H / KV query heads that share a KV head.  Inputs and
// outputs are bf16 or f32 (all one dtype); every sum is f32.  (D, Dv) =
// (64, 64) (llama3.2-1b's heads, granite-moe-3b-a800m's, seamless-m4t-
// medium's), (128, 128) (starcoder2-7b's, granite-20b's, chameleon-34b's),
// (192, 128) (deepseek-v3-671b's MLA in training) or (256, 256)
// (gemma-7b's, recurrentgemma-2b's); the wrapper refuses other pairs, and
// takes non-causal calls at (64, 64) only.
//
// Design: three kernels, launched in order by one entry, no atomics (a
// replay gives the same bits):
//   * setup: one block per (batch, head, tile of 32 query rows) recomputes
//     each row's log-sum-exp over its live keys (an online max and sum over
//     32-key tiles) and D = rowsum(dO * o), into f32 scratch (B, H, Sq).
//     The forward kernels, which serving captures in CUDA graphs, keep
//     their outputs as they are;
//   * dK/dV: one block per (batch, KV head, tile of 32 keys, 64 columns)
//     keeps dK and dV of its keys and columns in registers (a 4 x 4 patch
//     of each per thread) and loops over the G heads and the live query
//     tiles of its keys (causal: at or after them): S and dO v^T as 32 x 32
//     tiles over the full D and Dv (a 2 x 4 patch per thread), P and dS
//     into shared memory, then dV += P^T dO and dK += dS^T q on its
//     columns;
//   * dQ: one block per (batch, head, tile of 32 query rows, 64 columns)
//     loops over the live key tiles (causal: at or before its rows) and
//     sums dQ += dS k on its columns in registers.
// At D 128, 192 and 256 the two to four column blocks of a tile each
// recompute S over the full D and dP over the full Dv: the accumulators
// keep the registers of D 64, and the tiles (f32, full width) fit a
// block's shared memory; at (192, 128) the third column block of a dK/dV
// tile holds dK's columns alone.  The window bounds each block's tiles (a
// dQ block starts at the tile of its first row's first live key, a dK/dV
// block ends at the tile of the last query whose window reaches its last
// key); a non-causal block visits every tile of the other sequence; masks
// are per element.
// Tiles are staged in shared memory as f32 (row-major, or transposed where
// a product reads them by column), rows past Sq or Skv as zeros; the
// products are CUDA-core FMAs.
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
  float* lse;       // (B, H, Sq)
  float* delta;     // (B, H, Sq)
  long long B, Sq, Skv, H, KV, cols;
  long long window; // causal: keys at or before q - window masked (>= 1)
  int causal;       // 0: every key of Skv live for every query
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

// whether key j is live for query i: a query of Sq, and causal, the key at
// or before it, inside its window; non-causal, a key of Skv
__device__ __forceinline__ bool live(long long i, long long j,
                                     const Params& p) {
  return i < p.Sq && (p.causal ? j <= i && j > i - p.window : j < p.Skv);
}

// the first key tile (its first key) of query rows i0 ..: causal, the tile
// holding the first row's first live key; non-causal, 0
__device__ __forceinline__ long long first_key_tile(long long i0,
                                                    const Params& p) {
  const long long k = p.causal && i0 - p.window + 1 > 0 ? i0 - p.window + 1
                                                        : 0;
  return k / kT * kT;
}

// the last key tile (its first key) of query rows i0 ..: causal, the tile
// holding the last row's diagonal; non-causal, Skv's last
__device__ __forceinline__ long long last_key_tile(long long i0,
                                                   const Params& p) {
  const long long k = p.causal ? (i0 + kT < p.Sq ? i0 + kT : p.Sq) - 1
                               : p.Skv - 1;
  return k / kT * kT;
}

template <int kD>
constexpr size_t setup_smem() {
  return sizeof(float) * (kT * ld<kD>() + kD * kLt);
}

// The log-sum-exp of each query row's scaled scores over its live keys,
// and D = rowsum(dO * o).  Grid (query tiles, B * H).
template <int kD, int kDv, typename T>
__global__ void __launch_bounds__(kThreads) bwd_setup_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // kT x ld<kD>
  float* Kt = Qs + kT * ld<kD>();    // kD x kLt
  const long long Sq = p.Sq, Skv = p.Skv, H = p.H, KV = p.KV, G = H / KV;
  const long long b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const long long i0 = (long long)blockIdx.x * kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* q = static_cast<const T*>(p.q) + (b * Sq * H + h) * kD;
  const T* k = static_cast<const T*>(p.k) + (b * Skv * KV + kvh) * kD;
  const T* o = static_cast<const T*>(p.o) + (b * Sq * H + h) * kDv;
  const T* dout = static_cast<const T*>(p.dout) + (b * Sq * H + h) * kDv;
  float* lse = p.lse + (b * H + h) * Sq;
  float* delta = p.delta + (b * H + h) * Sq;

  // D: one warp a row (the branch is uniform over the warp)
  for (int r = warp; r < kT; r += kThreads / 32) {
    const long long i = i0 + r;
    if (i < Sq) {
      const T* orow = o + i * H * kDv;
      const T* drow = dout + i * H * kDv;
      float x = to_f32(orow[lane]) * to_f32(drow[lane]);
#pragma unroll
      for (int d = 32; d < kDv; d += 32)
        x += to_f32(orow[lane + d]) * to_f32(drow[lane + d]);
      x = warp_sum(x);
      if (lane == 0) delta[i] = x;
    }
  }

  load_rows<kD>(Qs, q, i0, Sq, H * kD);
  const int ti = tid >> 3, tj = tid & 7;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const long long j_last = last_key_tile(i0, p);
  for (long long j0 = first_key_tile(i0, p); j0 <= j_last; j0 += kT) {
    __syncthreads();
    load_cols<kD>(Kt, k, j0, Skv, KV * kD);
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
        s[r][c] = live(i, j, p) ? s[r][c] * p.scale : -INFINITY;
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
      if (i < Sq) lse[i] = m[r] + logf(l[r]);
    }
  }
}

// P and dS of one 32 x 32 tile, a 2 x 4 patch per thread, from the scores
// s and dP = dO v^T; dead pairs (causal: after a row's diagonal, at or
// before its window; non-causal: keys past Skv) and rows past Sq get 0.
__device__ __forceinline__ void probs(float (&s)[2][4], float (&dp)[2][4],
                                      const float* lse_s, const float* del_s,
                                      long long i0, long long j0,
                                      const Params& p, int ti, int tj) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = i0 + 2 * ti + r;
    const float li = lse_s[2 * ti + r], di = del_s[2 * ti + r];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long j = j0 + 4 * tj + c;
      const float pr = live(i, j, p) ? expf(s[r][c] * p.scale - li) : 0.f;
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

template <int kD, int kDv>
constexpr size_t dkdv_smem() {
  return sizeof(float) * ((kD + kDv) * kLt + kT * (ld<kD>() + ld<kDv>()) +
                          2 * kT * kLt + 2 * kT);
}
template <int kD, int kDv>
constexpr size_t dq_smem() {
  return sizeof(float) * (kT * (ld<kD>() + ld<kDv>()) + (kD + kDv) * kLt +
                          kT * ld<kC>() + kT * kLt + 2 * kT);
}
static_assert(dq_smem<128, 128>() <= 232448 &&
                  dkdv_smem<128, 128>() <= 232448 &&
                  dq_smem<192, 128>() <= 232448 &&
                  dkdv_smem<192, 128>() <= 232448 &&
                  dq_smem<256, 256>() <= 232448 &&
                  dkdv_smem<256, 256>() <= 232448,
              "a block's shared memory");

// dK and dV of 32 keys and 64 columns of one KV head (at D > Dv the column
// blocks past Dv's hold dK's columns alone).  Grid (key tiles of Skv, B *
// KV * column blocks).
template <int kD, int kDv, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(Params p) {
  constexpr int kL = ld<kD>(), kLv = ld<kDv>();
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                  // kD x kLt
  float* Vt = Kt + kD * kLt;         // kDv x kLt
  float* Qs = Vt + kDv * kLt;        // kT x kL
  float* dOs = Qs + kT * kL;         // kT x kLv
  float* Ps = dOs + kT * kLv;        // kT x kLt
  float* dSs = Ps + kT * kLt;        // kT x kLt
  float* lse_s = dSs + kT * kLt;     // kT
  float* del_s = lse_s + kT;         // kT

  const long long Sq = p.Sq, Skv = p.Skv, H = p.H, KV = p.KV, G = H / KV;
  const long long bk = blockIdx.y / p.cols;
  const int c0 = (int)(blockIdx.y - bk * p.cols) * kC;
  const bool has_v = c0 < kDv;      // uniform over the block
  const long long b = bk / KV, kvh = bk % KV;
  const long long j0 = (long long)blockIdx.x * kT;
  const int tid = threadIdx.x;
  const T* kb = static_cast<const T*>(p.k) + (b * Skv * KV + kvh) * kD;
  const T* vb = static_cast<const T*>(p.v) + (b * Skv * KV + kvh) * kDv;
  load_cols<kD>(Kt, kb, j0, Skv, KV * kD);
  load_cols<kDv>(Vt, vb, j0, Skv, KV * kDv);

  const int ti = tid >> 3, tj = tid & 7;    // score patch: rows, keys
  const int tk = tid >> 4, td = tid & 15;   // dK/dV patch: keys, dims
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[a][c] = dv[a][c] = 0.f;

  // causal: the query tiles at or after the block's keys whose last row's
  // window reaches its last key; non-causal: every query tile
  const long long W = p.window;
  const long long i_begin = p.causal ? j0 : 0;
  const long long i_end =
      !p.causal ? Sq : j0 + kT - 1 + W - 1 < Sq ? j0 + kT - 1 + W : Sq;
  for (long long g = 0; g < G; ++g) {
    const long long h = kvh * G + g;
    const T* qb = static_cast<const T*>(p.q) + (b * Sq * H + h) * kD;
    const T* db = static_cast<const T*>(p.dout) + (b * Sq * H + h) * kDv;
    const float* lse = p.lse + (b * H + h) * Sq;
    const float* delta = p.delta + (b * H + h) * Sq;
    for (long long i0 = i_begin; i0 < i_end; i0 += kT) {
      __syncthreads();
      load_rows<kD>(Qs, qb, i0, Sq, H * kD);
      load_rows<kDv>(dOs, db, i0, Sq, H * kDv);
      load_row_stats(lse_s, del_s, lse, delta, i0, Sq);
      __syncthreads();
      float s[2][4], dp[2][4];
      tile_product<kD>(Qs, Kt, ti, tj, s);
      tile_product<kDv>(dOs, Vt, ti, tj, dp);
      probs(s, dp, lse_s, del_s, i0, j0, p, ti, tj);
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
        const float4 sv = *reinterpret_cast<const float4*>(dSs + i * kLt +
                                                           4 * tk);
        const float4 qv = *reinterpret_cast<const float4*>(
            Qs + i * kL + c0 + 4 * td);
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) dk[a][c] = fmaf(sa[a], qa[c], dk[a][c]);
        if (has_v) {
          const float4 pv = *reinterpret_cast<const float4*>(Ps + i * kLt +
                                                             4 * tk);
          const float4 ov = *reinterpret_cast<const float4*>(
              dOs + i * kLv + c0 + 4 * td);
          const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
          const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              dv[a][c] = fmaf(pa[a], oa[c], dv[a][c]);
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + (b * Skv * KV + kvh) * kD + c0;
  T* dvb = static_cast<T*>(p.dv) + (b * Skv * KV + kvh) * kDv + c0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long j = j0 + 4 * tk + a;
    if (j >= Skv) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      store(dkb + j * KV * kD + 4 * td + c, dk[a][c] * p.scale);
      if (has_v) store(dvb + j * KV * kDv + 4 * td + c, dv[a][c]);
    }
  }
}

// dQ of 32 query rows and 64 columns of one head.  Grid (query tiles of
// Sq, B * H * column blocks).
template <int kD, int kDv, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(Params p) {
  constexpr int kL = ld<kD>(), kLv = ld<kDv>(), kLc = ld<kC>();
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // kT x kL
  float* dOs = Qs + kT * kL;         // kT x kLv
  float* Kt = dOs + kT * kLv;        // kD x kLt
  float* Vt = Kt + kD * kLt;         // kDv x kLt
  float* Ks = Vt + kDv * kLt;        // kT x kLc: the block's columns of k
  float* dSs = Ks + kT * kLc;        // kT x kLt
  float* lse_s = dSs + kT * kLt;     // kT
  float* del_s = lse_s + kT;         // kT

  const long long Sq = p.Sq, Skv = p.Skv, H = p.H, KV = p.KV, G = H / KV;
  const long long bh = blockIdx.y / p.cols;
  const int c0 = (int)(blockIdx.y - bh * p.cols) * kC;
  const long long b = bh / H, h = bh % H, kvh = h / G;
  const long long i0 = (long long)blockIdx.x * kT;
  const int tid = threadIdx.x;
  const T* kb = static_cast<const T*>(p.k) + (b * Skv * KV + kvh) * kD;
  const T* vb = static_cast<const T*>(p.v) + (b * Skv * KV + kvh) * kDv;
  load_rows<kD>(Qs, static_cast<const T*>(p.q) + (b * Sq * H + h) * kD, i0,
                Sq, H * kD);
  load_rows<kDv>(dOs,
                 static_cast<const T*>(p.dout) + (b * Sq * H + h) * kDv, i0,
                 Sq, H * kDv);
  load_row_stats(lse_s, del_s, p.lse + (b * H + h) * Sq,
                 p.delta + (b * H + h) * Sq, i0, Sq);

  const int ti = tid >> 3, tj = tid & 7;    // score patch: rows, keys
  const int tq = tid >> 4, td = tid & 15;   // dQ patch: rows, dims
  float dq[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[a][c] = 0.f;

  const long long j_last = last_key_tile(i0, p);
  for (long long j0 = first_key_tile(i0, p); j0 <= j_last; j0 += kT) {
    __syncthreads();
    load_cols<kD>(Kt, kb, j0, Skv, KV * kD);
    load_cols<kDv>(Vt, vb, j0, Skv, KV * kDv);
    load_rows<kC>(Ks, kb, j0, Skv, KV * kD, c0);
    __syncthreads();
    float s[2][4], dp[2][4];
    tile_product<kD>(Qs, Kt, ti, tj, s);
    tile_product<kDv>(dOs, Vt, ti, tj, dp);
    probs(s, dp, lse_s, del_s, i0, j0, p, ti, tj);
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

  T* dqb = static_cast<T*>(p.dq) + (b * Sq * H + h) * kD + c0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long i = i0 + 4 * tq + a;
    if (i >= Sq) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      store(dqb + i * H * kD + 4 * td + c, dq[a][c] * p.scale);
  }
}

template <int kD, int kDv, typename T>
int run(Params p, cudaStream_t stream) {
  p.cols = kD / kC;
  constexpr int kSetup = (int)setup_smem<kD>();
  constexpr int kDkdv = (int)dkdv_smem<kD, kDv>();
  constexpr int kDq = (int)dq_smem<kD, kDv>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_setup_kernel<kD, kDv, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSetup);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dkdv_kernel<kD, kDv, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDkdv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dq_kernel<kD, kDv, T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kDq);
  if (e != cudaSuccess) return (int)e;
  const unsigned qtiles = (unsigned)((p.Sq + kT - 1) / kT);
  const unsigned ktiles = (unsigned)((p.Skv + kT - 1) / kT);
  bwd_setup_kernel<kD, kDv, T><<<dim3(qtiles, (unsigned)(p.B * p.H)),
                                 kThreads, kSetup, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv_kernel<kD, kDv, T>
      <<<dim3(ktiles, (unsigned)(p.B * p.KV * p.cols)), kThreads, kDkdv,
         stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dq_kernel<kD, kDv, T><<<dim3(qtiles, (unsigned)(p.B * p.H * p.cols)),
                              kThreads, kDq, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run_d(const Params& p, long long D, long long Dv, cudaStream_t stream) {
  if (D == 64 && Dv == 64) return run<64, 64, T>(p, stream);
  if (D == 128 && Dv == 128) return run<128, 128, T>(p, stream);
  if (D == 192 && Dv == 128) return run<192, 128, T>(p, stream);
  if (D == 256 && Dv == 256) return run<256, 256, T>(p, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` and returns cudaGetLastError()
// (0 when every launch was accepted).  Sizes are elements; window <= 0
// means none; causal 0 means non-causal (then no window, (D, Dv) (64,
// 64)).  The wrapper has checked shapes ((D, Dv) (64, 64), (128, 128),
// (192, 128) or (256, 256); causal: Sq = Skv), dtypes, contiguity,
// alignment and Sq, Skv > 0, and allocated dq, dk, dv and the f32 scratch
// lse and delta (B * H * Sq each).
int repro_flash_backward(int is_bf16, const void* q, const void* k,
                         const void* v, const void* o, const void* dout,
                         void* dq, void* dk, void* dv, void* lse,
                         void* delta, long long B, long long Sq,
                         long long Skv, long long H, long long KV,
                         long long D, long long Dv, long long window,
                         int causal, float scale, void* stream) {
  if (KV <= 0 || H % KV || (causal && Sq != Skv) ||
      (!causal && (window >= 1 || D != 64 || Dv != 64)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV;
  p.window = window >= 1 && window < Skv ? window : Skv;
  p.causal = causal ? 1 : 0;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run_d<__nv_bfloat16>(p, D, Dv, s)
                 : run_d<float>(p, D, Dv, s);
}

}  // extern "C"
