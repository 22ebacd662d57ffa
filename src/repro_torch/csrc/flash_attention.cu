// Forward flash attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas` / `_fa_kernel`
// (src/repro/kernels/flash_attention/kernel.py): GQA attention with an
// online softmax, causal, sliding `window`, and `q_start` / `kv_len`
// against a decode cache; m, l and the accumulator in f32; fully masked
// KV tiles skipped.  Layouts are the public function's: q (B,Sq,H,D),
// k (B,Skv,KV,D), v (B,Skv,KV,Dv), out (B,Sq,H,Dv) in q's dtype; bf16 or
// f32 inputs.  Query head h reads KV head h / G, G = H / KV.  (D, Dv) is
// (16, 16), (64, 64), (128, 128), (192, 128) or (256, 256); the wrapper
// refuses others.
//
// Design.  The TPU kernel walks the KV blocks as a sequential grid axis and
// keeps m/l/acc in VMEM scratch across grid steps.  Here one block of 128
// threads (4 warps) owns up to 4*RPW query rows of ONE KV head, a row being
// a (query position, head of the group) pair, so the G = H / KV query heads
// that share a KV head read each K/V tile once.  The block loops over KV
// tiles of 32 keys inside itself:
//   * the tile is read in 16-byte vectors into registers one tile ahead
//     (its loads are in flight while the previous tile is computed), then
//     staged in shared memory as f32 (K rows padded to D + 1 floats, so
//     lane j reading key j is free of bank conflicts); rows at or beyond
//     min(kv_len, Skv) are staged as zeros, so the ragged tail and
//     whatever lies in the cache beyond kv_len never reach the sums;
//   * lane j computes the scores of key j for the warp's RPW rows (CUDA-core
//     FMAs), the row max and sum are warp shuffles, and each lane keeps
//     ceil(Dv / 32) columns of each row's accumulator in registers;
//   * only tiles that hold a live key are visited: the tile range is the
//     block-level test of `_fa_kernel` (beyond kv_len, after the causal
//     diagonal of the block's last query, before the window of its first);
//   * masked keys get probability 0 (a row with no live key gives 0, as
//     `attention_ref` does), and the result is acc / max(l, 1e-30).
// Any Skv is taken: the Pallas assert Skv % bk == 0 has no counterpart.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   * decode (Sq = 1): bytes.  It must read K and V for kv_len rows: at
//     llama3.2-1b's shape (KV 8, D 64, bf16, kv_len 1056) 2.2 MB per layer,
//     0.65 us at the memory's rate.
//   * prefill (Sq = Skv = P, causal): operations, 2*2*H*P*P*D / 2 over the
//     tensor cores' bf16 rate; 4.3 GFLOP per layer at P = 1024, 4.3 us.
// What the simple design leaves on the table, and where it went:
//   * decode ran B * KV blocks, 8 for llama3.2-1b at batch 1 and one for
//     recurrentgemma-2b (MQA), each walking all of its tiles in turn:
//     latency-bound, far from the byte bound.  Every call with
//     Sq * G <= 16 now goes to the split-K decode, flash_decode.cu;
//   * prefill uses CUDA-core f32 FMAs, not the tensor cores, and stages
//     tiles through registers (MLA's (192, 128) prefill at deepseek-v3-671b's
//     shape: 3.95 ms, 36x SDPA).  bf16 calls with Sq * G > 16 at (64, 64),
//     (128, 128), (192, 128) and (256, 256) now go to the `wgmma` prefill,
//     flash_prefill_sm90.cu.
// This kernel still serves the rest, by the fixed rule of
// kernels/flash_attention/kernel.py (`pick_route`): f32 calls with
// Sq * G > 16, and the (16, 16) pair with Sq * G > 16.  Its numbers stay
// in PERF.md beside the new kernels'.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;       // keys per tile: one per lane
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long B, Sq, Skv, H, KV, D, Dv;
  long long q_start, kv_len, window;   // kv_len <= Skv; window < 0: none
  int causal;
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// 16-byte vectors of T: tiles move between device and shared memory in
// these (8 bf16 or 4 f32 values); the wrapper checks the alignment.
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

// DMAX: the largest head dim the instance takes (D, Dv <= DMAX);
// RPW: query rows per warp.
template <typename T, int DMAX, int RPW>
__global__ void __launch_bounds__(kThreads) fa_fwd_kernel(Params p) {
  constexpr int kRows = kWarps * RPW;
  constexpr int kCols = DMAX / 32;            // accumulator columns per lane
  constexpr int kVec = Vec<T>::n;
  // 16-byte vectors each thread moves per tile, for K and for V
  constexpr int kLoads = (kTile * DMAX / kVec + kThreads - 1) / kThreads;
  extern __shared__ float smem[];
  const int D = (int)p.D, Dv = (int)p.Dv;
  float* Qs = smem;                           // kRows x D, pre-scaled
  float* Ks = Qs + kRows * D;                 // kTile x (D + 1)
  float* Vs = Ks + kTile * (D + 1);           // kTile x Dv

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  const long long G = p.H / p.KV;
  const long long b = blockIdx.y / p.KV;
  const long long kvh = blockIdx.y % p.KV;
  const long long nrows = p.Sq * G;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    const long long row = row0 + r;
    float x = 0.f;
    if (row < nrows) {
      const long long qi = row / G, h = kvh * G + row % G;
      x = to_f32(q[((b * p.Sq + qi) * p.H + h) * D + d]) * p.scale;
    }
    Qs[i] = x;
  }

  // the block's live key range: [k_begin, k_end)
  const long long last = (row0 + kRows < nrows ? row0 + kRows : nrows) - 1;
  const long long qpos_lo = p.q_start + row0 / G;
  const long long qpos_hi = p.q_start + last / G;
  long long k_end = p.kv_len;
  if (p.causal && qpos_hi + 1 < k_end) k_end = qpos_hi + 1;
  long long k_begin = 0;
  if (p.window >= 0 && qpos_lo - p.window + 1 > 0)
    k_begin = qpos_lo - p.window + 1;

  bool valid[RPW];
  long long qpos[RPW];
  float m[RPW], l[RPW], acc[RPW][kCols];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const long long row = row0 + warp * RPW + r;
    valid[r] = row < nrows;
    qpos[r] = p.q_start + row / G;
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  // K/V tiles: loaded into registers one tile ahead (the loads of tile
  // t + 1 are in flight while tile t is computed), then converted to f32
  // in shared memory.  Rows at or beyond kv_len are zeros.
  const int k_vpr = D / kVec, v_vpr = Dv / kVec;   // vectors per row
  uint4 kbuf[kLoads], vbuf[kLoads];
  auto load_tile = [&](long long t) {
    const long long kb = t * kTile;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      kbuf[u] = make_uint4(0, 0, 0, 0);
      vbuf[u] = make_uint4(0, 0, 0, 0);
      if (i < kTile * k_vpr) {
        const int j = i / k_vpr, c = i - j * k_vpr;
        if (kb + j < p.kv_len)
          kbuf[u] = *reinterpret_cast<const uint4*>(
              k + ((b * p.Skv + kb + j) * p.KV + kvh) * D + c * kVec);
      }
      if (i < kTile * v_vpr) {
        const int j = i / v_vpr, c = i - j * v_vpr;
        if (kb + j < p.kv_len)
          vbuf[u] = *reinterpret_cast<const uint4*>(
              v + ((b * p.Skv + kb + j) * p.KV + kvh) * Dv + c * kVec);
      }
    }
  };
  auto store_tile = [&]() {
    float x[kVec];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = tid + u * kThreads;
      if (i < kTile * k_vpr) {
        const int j = i / k_vpr, c = i - j * k_vpr;
        unpack(kbuf[u], x, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) Ks[j * (D + 1) + c * kVec + e] = x[e];
      }
      if (i < kTile * v_vpr) {
        unpack(vbuf[u], x, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) Vs[i * kVec + e] = x[e];
      }
    }
  };

  const long long t_begin = k_begin / kTile;
  const long long t_end = k_end > k_begin ? (k_end + kTile - 1) / kTile : 0;
  if (t_begin < t_end) load_tile(t_begin);
  for (long long t = t_begin; t < t_end; ++t) {
    const long long kb = t * kTile;
    store_tile();
    __syncthreads();
    if (t + 1 < t_end) load_tile(t + 1);

    // scores of key kb + lane for this warp's rows
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * (D + 1);
    const float* qr = Qs + warp * RPW * D;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + r * D + d);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }

    // online softmax update (every branch below is uniform over the warp)
    const long long kj = kb + lane;
    float pr[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      bool live = valid[r] && kj < p.kv_len;
      if (p.causal) live = live && kj <= qpos[r];
      if (p.window >= 0) live = live && kj > qpos[r] - p.window;
      const float sr = live ? s[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sr));
      float pj = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {
        pj = live ? expf(sr - m_new) : 0.f;
        corr = expf(m[r] - m_new);      // 0 while the row had no live key
        m[r] = m_new;
      }
      l[r] = l[r] * corr + warp_sum(pj);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
      pr[r] = pj;
    }

    // acc += p @ V: lane owns columns c * 32 + lane
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = c * 32 + lane;
        vj[c] = d < Dv ? Vs[j * Dv + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(kFull, pr[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (!valid[r]) continue;
    const long long row = row0 + warp * RPW + r;
    const long long qi = row / G, h = kvh * G + row % G;
    T* orow = o + ((b * p.Sq + qi) * p.H + h) * Dv;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = c * 32 + lane;
      if (d < Dv) store(orow + d, acc[r][c] / denom);
    }
  }
}

template <typename T, int DMAX, int RPW>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int kRows = kWarps * RPW;
  const size_t smem =
      sizeof(float) * (kRows * p.D + kTile * (p.D + 1) + kTile * p.Dv);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_kernel<T, DMAX, RPW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long nrows = p.Sq * (p.H / p.KV);
  const dim3 grid((unsigned)((nrows + kRows - 1) / kRows),
                  (unsigned)(p.B * p.KV));
  fa_fwd_kernel<T, DMAX, RPW><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// one row per warp when the block's rows are few (decode), else four
template <typename T, int DMAX>
int launch_rows(const Params& p, cudaStream_t stream) {
  if (p.Sq * (p.H / p.KV) <= kWarps) return launch<T, DMAX, 1>(p, stream);
  return launch<T, DMAX, 4>(p, stream);
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  const long long dmax = p.D > p.Dv ? p.D : p.Dv;
  if (dmax <= 32) return launch_rows<T, 32>(p, stream);    // D 16
  if (dmax <= 64) return launch_rows<T, 64>(p, stream);    // D 64
  if (dmax <= 128) return launch_rows<T, 128>(p, stream);  // D 128
  if (dmax <= 192) return launch_rows<T, 192>(p, stream);  // D 192, Dv 128
  if (dmax <= 256) return launch_rows<T, 256>(p, stream);  // D 256
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   long long B, long long Sq, long long Skv, long long H,
                   long long KV, long long D, long long Dv, long long q_start,
                   long long kv_len, long long window, int causal,
                   float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.D = D; p.Dv = Dv;
  p.q_start = q_start;
  p.kv_len = kv_len < Skv ? kv_len : Skv;
  p.window = window;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` and returns cudaGetLastError() (0 when
// the launch was accepted).  Sizes are elements; the wrapper has checked
// shapes, dtypes and contiguity.
int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                               void* o, long long B, long long Sq,
                               long long Skv, long long H, long long KV,
                               long long D, long long Dv, long long q_start,
                               long long kv_len, long long window, int causal,
                               float scale, void* stream) {
  return dispatch<__nv_bfloat16>(
      make_params(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, q_start, kv_len,
                  window, causal, scale),
      static_cast<cudaStream_t>(stream));
}

int repro_flash_attention_f32(const void* q, const void* k, const void* v,
                              void* o, long long B, long long Sq,
                              long long Skv, long long H, long long KV,
                              long long D, long long Dv, long long q_start,
                              long long kv_len, long long window, int causal,
                              float scale, void* stream) {
  return dispatch<float>(
      make_params(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, q_start, kv_len,
                  window, causal, scale),
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
