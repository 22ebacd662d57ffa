// Split-K decode attention for Hopper (sm_90a), one launch, plain C
// interface.
//
// Replaces, for decode (Sq = 1) and the short multi-token decode -- every
// call whose rows number Sq * G <= 16, and every call whose position or
// length lives on the device, in blocks of 16 rows -- the Pallas TPU kernel
// `flash_attention_pallas` / `_fa_kernel`
// (src/repro/kernels/flash_attention/kernel.py): GQA attention with an
// online softmax, causal, sliding `window`, `q_start` / `kv_len` against a
// decode cache, m / l / acc in f32, a row with no live key gives 0, the
// result is acc / max(l, 1e-30).  Layouts are the public function's:
// q (B,Sq,H,D), k (B,Skv,KV,D), v (B,Skv,KV,Dv), out (B,Sq,H,Dv) in q's
// dtype; bf16 or f32; (D, Dv) any pair of HEAD_DIMS (16/16, 64/64,
// 128/128, 192/128, 256/256).  A row is a (query position, head of the
// group) pair, row = qi * G + g, so the G query heads of a KV head read each
// K/V tile once.
//
// Row blocks: a block takes at most kMaxRows = 16 rows (one warp each).  A
// call with more rows (granite-20b's multi-query decode: G = 48) runs
// ceil(Sq * G / 16) row blocks of one (b, KV head) side by side, grid z;
// block z takes rows [16 z, 16 z + 16), each row block reads the K/V tiles
// of its split once for its rows (so G = 48 reads them three times, from
// L2 after the first), and each (pair, row block) merges on its own.  A
// call of at most 16 rows has one row block (grid z = 1, row0 = 0, all of
// its rows in the block), and every operation of it runs in the order of
// the kernel before row blocks, bit for bit.
//
// Why split: at batch 1 the simple kernel (flash_attention.cu) runs B * KV
// blocks, 8 for llama3.2-1b and ONE for recurrentgemma-2b (MQA), each
// walking its whole cache; the card sits empty while one SM waits on its
// loads.  Decode is bound by bytes (K and V of the live keys read once:
// 2.2 MB per llama layer at kv_len 1056, 2.1 MB per Griffin layer over its
// 2048-key window; about 0.65 us at 3.35 TB/s), so the keys must be spread
// over the SMs.
//
// Grid (S, B * KV, row blocks).  The live key range of a (b, KV head) is the one the
// simple kernel computes for its row block ([k_begin, k_end): beyond
// kv_len, after the causal diagonal of the last query, before the window of
// the first), cut into tiles of kTile = 32 keys, tiles [t0, t1).  The rule
// for S (the wrapper's `decode_splits`, which the plain version shares):
// n = t1 - t0 tiles; about 132 blocks (one per SM) over the B * KV pairs
// and their RB row blocks, want = ceil(132 / (B * KV * RB)), but no more
// splits than keep the partials that the merging block reads (S * rows of
// its row block * (Dv + 2) f32) within 384 KB;
// tpc = ceil(n / min(n, want)) tiles per split, S = ceil(n / tpc).  So
// llama3.2-1b (B * KV = 8, 1056 keys, 33 tiles): 17 splits of 2 tiles
// (64 keys); recurrentgemma-2b (B * KV = 1, 10 rows of Dv 256, 2048 live
// keys, 64 tiles): 32 splits of 2 tiles; granite-20b (B * KV = 1, 48 rows
// in 3 row blocks, 1056 keys): 33 splits of one tile, 99 blocks.  A caller may ask for S itself
// (tests); splits past the end of the range are empty and give m = -inf.
//
// The position on the device: with `q_pos` given (a captured decode step,
// one launch for every position), the kernel reads q_start from it, takes
// kv_len = min(q_start + Sq, Skv) and finds t0 from the live range itself.
// `q_pos` holds one position for every batch row (stride 0: the serial
// step) or one per row (stride 1: the batched step, whose rows decode at
// their own positions); each (b, KV head) block reads its row's, so rows
// at different positions share one grid.
// The wrapper then sets S and tpc by the same rule over the most tiles the
// live range can touch at any position (`capacity_splits`): ceil(Skv / 32),
// and with a causal window no more than ceil((window + Sq) / 32) + 1.  At
// the served shapes that gives 17 splits of 2 tiles (llama3.2-1b, 1056
// keys) and 33 of 2 (recurrentgemma-2b, 2592 keys, window 2048), the host
// rule's splits within one.
//
// The length on the device: with `kv_pos` given (int32, the encoder-decoder's
// `enc_len` leaf of the decode state, which a captured cross-attention step
// reads where it lies), kv_len = min(kv_pos[b * kv_pos_stride], Skv) and
// q_start stays the host's (0 for cross-attention); stride 0 gives every
// batch row one length, stride 1 each row its own (the batched step).  The
// kernel finds t0 from the live range, as at a device position, and the
// wrapper splits by `capacity_splits` over Skv.  int32 because the leaf is:
// a cast to int64 would be one more launch a decoder layer and token.
//
// Inside a block (one warp per query row: 4 warps for up to 4 rows, else
// 16): Q and the split's tiles come through a ring of two shared-memory
// stages filled by 16-byte `cp.async` copies (Q with the first tile, so
// the two latencies overlap; K rows padded by 16 bytes so that lane j
// reading key j is free of bank conflicts; rows at or beyond kv_len are
// zero-filled, never read from the cache).  Lane j scores key j of the tile
// (f32 FMAs, four partial sums), the row max and sum are warp shuffles,
// lane c owns Dv / 32 consecutive columns of the row's accumulator.  The
// block's partial (acc, m, l) per row goes to an f32 scratch
// (B*KV, S, G*Sq, Dv+2) that the wrapper allocates with torch.empty (each
// row block writes its own rows of it).
//
// Merge, in the same launch: each block writes its partials, runs
// __threadfence() and atomicAdd's a per-(b, KV head, row block) int32
// counter; the block of its row block that arrives last reads the S
// partials of its rows (M = max m_s,
// out = sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s, 1e-30); a split
// with m_s = -inf weighs exactly 0, and a row whose splits are all -inf
// gives 0), stores the output in q's dtype and resets the counter to 0.
// The sums over splits run in split order (the denominator over a fixed
// xor tree of lanes), with no atomics on values: the result does not depend
// on the order in which blocks finish.  The merging block's loads are
// issued in batches (all of a batch before any use): one at a time, each
// would cost an L2 round trip.  The counters (one per (b, KV head, row
// block), at (b * KV + kvh) * RB + z, zeroed once by the wrapper and left
// at 0 by every launch) are shared by all
// calls on a device, so calls that share them must run on one stream, as
// serial decode does.  One launch and not two because decode is host-bound
// (21-26 us of host time per device activity): a second combine launch
// would add a device activity per attention layer and token.
//
// Where the time goes: `tools/flash_kernel_probe.py phases` stamps each
// phase with clock64 (PERF.md gives its numbers).  A tile is latency-bound
// on CUDA-core FMAs and shuffles, most at recurrentgemma-2b's D 256; the
// merge costs a few L2 round trips plus a read of every split's partials,
// which is why the split rule caps the bytes it reads.  `-Xptxas -v`: no
// spills in any instance (registers and shared memory in PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;          // keys per tile: one per lane
constexpr int kStages = 2;
constexpr int kMaxRows = 16;       // rows of a row block, one warp each
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* part;                     // (B*KV, S, R, Dv + 2)
  int* counter;                    // (B*KV*RB,), 0 between launches
  long long B, Sq, Skv, H, KV, D, Dv;
  long long q_start, kv_len, window;   // kv_len <= Skv; window < 0: none
  int causal;
  float scale;
  long long t0, tpc, S;            // first live tile, tiles per split, splits
  const long long* q_pos;          // the position on the device, or null
  long long q_pos_stride;          // 0: one position for every row; 1: a
                                   // position per batch row, q_pos[b]
  const int* kv_pos;               // kv_len on the device, or null
  long long kv_pos_stride;         // 0 or 1, as q_pos_stride
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements of T from shared memory, as f32, in the widest
// loads their alignment allows (the caller keeps src aligned to N elements)
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* src, float (&x)[N]) {
  constexpr int bytes = N * (int)sizeof(T);
  if constexpr (bytes >= 16) {
    constexpr int per = 16 / (int)sizeof(T);
#pragma unroll
    for (int w = 0; w < bytes / 16; ++w) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[w];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < per; ++i) x[w * per + i] = to_f32(e[i]);
    }
  } else if constexpr (bytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(e[i]);
  } else if constexpr (bytes == 4) {
    const unsigned u = *reinterpret_cast<const unsigned*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f32(e[i]);
  } else {
    x[0] = to_f32(src[0]);
  }
}

// DMAX: the Dv bucket; lane c owns the DMAX / 32 consecutive columns from
// c * DMAX / 32 of its row's accumulator.  NW: warps, one per query row (the
// instance takes up to NW rows a block); a call with more rows than NW
// runs in row blocks of NW along grid z.
template <typename T, int DMAX, int NW>
__global__ void __launch_bounds__(NW * 32) flash_decode_kernel(Params p) {
  constexpr int kThreads = NW * 32;
  constexpr int kCols = DMAX / 32;
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte copy
  // float2 output units (a row, two columns) each thread merges, and the
  // splits whose loads the merge keeps in flight together
  constexpr int kUnits = (NW * DMAX / 2 + kThreads - 1) / kThreads;
  constexpr int kBatch = 16 / kUnits;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = (int)p.D, Dv = (int)p.Dv;
  const int kstride = D + kVec;              // K row, padded by 16 bytes
  const long long G = p.H / p.KV;
  const int R = (int)(p.Sq * G);             // rows of the call
  const int row0 = (int)blockIdx.z * NW;     // the block's rows
  const int Rb = R - row0 < NW ? R - row0 : NW;
  // this (b, KV head, row block)'s arrival counter
  const long long ci = (long long)blockIdx.y * gridDim.z + blockIdx.z;
  float* Qs = reinterpret_cast<float*>(smem_raw);     // NW x D, scaled
  T* Qraw = reinterpret_cast<T*>(Qs + NW * D);        // NW x D, as loaded
  T* Ks = Qraw + NW * D;                              // stages x tile
  T* Vs = Ks + kStages * kTile * kstride;
  float* W = reinterpret_cast<float*>(Ks);   // merge: S x R m and l

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const long long bk = blockIdx.y;           // b * KV + kvh
  const long long b = bk / p.KV, kvh = bk % p.KV;
  const long long split = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the position: the host's, or read from the device (this batch row's)
  long long q_start = p.q_start, kv_len = p.kv_len;
  if (p.q_pos != nullptr) {
    q_start = p.q_pos[b * p.q_pos_stride];
    kv_len = q_start + p.Sq < p.Skv ? q_start + p.Sq : p.Skv;
  }
  if (p.kv_pos != nullptr) {
    const long long n = p.kv_pos[b * p.kv_pos_stride];
    kv_len = n < 0 ? 0 : (n < p.Skv ? n : p.Skv);
  }
  // the block-level live range, as the wrapper's live_tiles computes it
  const long long qpos_lo = q_start, qpos_hi = q_start + p.Sq - 1;
  long long k_end = kv_len;
  if (p.causal && qpos_hi + 1 < k_end) k_end = qpos_hi + 1;
  long long k_begin = 0;
  if (p.window >= 0 && qpos_lo - p.window + 1 > 0)
    k_begin = qpos_lo - p.window + 1;
  const long long t_last = k_end > k_begin ? (k_end + kTile - 1) / kTile : 0;
  // this split's tiles: [ta, tb)
  const long long t0 =
      p.q_pos != nullptr || p.kv_pos != nullptr ? k_begin / kTile : p.t0;
  const long long ta = t0 + split * p.tpc;
  long long tb = ta + p.tpc;
  if (tb > t_last) tb = t_last;

  const int k_vpr = D / kVec, v_vpr = Dv / kVec;   // 16-byte copies per row
  auto load_tile = [&](long long t, int stage) {
    const long long kb = t * kTile;
    T* ks = Ks + stage * kTile * kstride;
    T* vs = Vs + stage * kTile * Dv;
    for (int i = tid; i < kTile * k_vpr; i += kThreads) {
      const int j = i / k_vpr, c = i - j * k_vpr;
      const bool in = kb + j < kv_len;
      const T* src = in ? k + ((b * p.Skv + kb + j) * p.KV + kvh) * D + c * kVec
                        : k;
      cp_async16(ks + j * kstride + c * kVec, src, in ? 16 : 0);
    }
    for (int i = tid; i < kTile * v_vpr; i += kThreads) {
      const int j = i / v_vpr, c = i - j * v_vpr;
      const bool in = kb + j < kv_len;
      const T* src = in ? v + ((b * p.Skv + kb + j) * p.KV + kvh) * Dv +
                              c * kVec
                        : v;
      cp_async16(vs + j * Dv + c * kVec, src, in ? 16 : 0);
    }
  };

  const int row = warp;                      // this warp's row of the block
  const bool valid = row < Rb;
  const long long qpos = q_start + (row0 + row) / G;
  float m = -INFINITY, l = 0.f, acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  const int d0 = lane * kCols;               // this lane's first column

  if (ta < tb) {
    // the block's Q rows (row = qi * G + g) and the first tile in one
    // copy group, so their latencies overlap
    const int q_vpr = D / kVec;
    for (int i = tid; i < Rb * q_vpr; i += kThreads) {
      const int r = i / q_vpr, c = i - r * q_vpr;
      const long long qi = (row0 + r) / G, h = kvh * G + (row0 + r) % G;
      cp_async16(Qraw + r * D + c * kVec,
                 q + ((b * p.Sq + qi) * p.H + h) * D + c * kVec, 16);
    }
    load_tile(ta, 0);
  }
  cp_async_commit();
  for (long long t = ta; t < tb; ++t) {
    const int stage = (int)((t - ta) & 1);
    if (t + 1 < tb) load_tile(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                      // tile t (and Q) landed
    __syncthreads();
    if (t == ta) {
      for (int i = tid; i < Rb * D; i += kThreads)
        Qs[i] = to_f32(Qraw[i]) * p.scale;
      __syncthreads();
    }
    if (valid) {                             // uniform over the warp
      const T* ks = Ks + stage * kTile * kstride;
      const T* vs = Vs + stage * kTile * Dv;
      const long long kj = t * kTile + lane;

      // the score of key kj for this warp's row, in four partial sums so
      // that the FMAs do not wait on each other
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      const T* kr = ks + lane * kstride;
      const float* qr = Qs + row * D;
#pragma unroll 4
      for (int dd = 0; dd < D; dd += kVec) {
        float kx[kVec];
        load_f32<T, kVec>(kr + dd, kx);
        // Q's row in 16-byte reads (rows are D floats, D a multiple of 16)
        const float4* q4 = reinterpret_cast<const float4*>(qr + dd);
#pragma unroll
        for (int e = 0; e < kVec / 4; ++e) {
          const float4 qv = q4[e];
          s4[0] = fmaf(qv.x, kx[4 * e], s4[0]);
          s4[1] = fmaf(qv.y, kx[4 * e + 1], s4[1]);
          s4[2] = fmaf(qv.z, kx[4 * e + 2], s4[2]);
          s4[3] = fmaf(qv.w, kx[4 * e + 3], s4[3]);
        }
      }
      const float s = (s4[0] + s4[1]) + (s4[2] + s4[3]);

      // online softmax update
      bool live = kj < kv_len;
      if (p.causal) live = live && kj <= qpos;
      if (p.window >= 0) live = live && kj > qpos - p.window;
      const float sr = live ? s : -INFINITY;
      const float m_new = fmaxf(m, warp_max(sr));
      float pj = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {
        pj = live ? expf(sr - m_new) : 0.f;
        corr = expf(m - m_new);              // 0 while the row had no live key
        m = m_new;
      }
      l = l * corr + warp_sum(pj);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] *= corr;

      // acc += p @ V over this lane's columns (a lane past Dv, at Dv 16,
      // reads column 0 and never stores: every lane takes part in the
      // shuffles)
      const int dl = d0 < Dv ? d0 : 0;
#pragma unroll 8
      for (int j = 0; j < kTile; ++j) {
        float vj[kCols];
        load_f32<T, kCols>(vs + j * Dv + dl, vj);
        const float pjj = __shfl_sync(kFull, pj, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(pjj, vj[c], acc[c]);
      }
    }
    __syncthreads();                         // the stage may be refilled
  }
  cp_async_wait<0>();

  // this split's partials: acc, then m, then l
  const long long ps = Dv + 2;
  float* part = p.part + (bk * p.S + split) * R * ps;
  if (valid) {
    float* pr = part + (row0 + row) * ps;
    if (d0 < Dv) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) pr[d0 + c] = acc[c];
    }
    if (lane == 0) {
      pr[Dv] = m;
      pr[Dv + 1] = l;
    }
  }

  // the last block of this (b, KV head, row block) to arrive merges the S
  // partials of its rows
  __shared__ int s_last;
  __shared__ float s_den[NW];
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(p.counter + ci, 1);
    s_last = prev == (int)p.S - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // Every global load below is issued in a batch before any of its values
  // is used: __ldcg pins program order, so a load next to its use would
  // wait out the L2's latency once per load.
  // 1. the S x Rb (m, l) pairs into shared memory (split sp, row r of the
  //    block at sp * Rb + r)
  const float* base = p.part + bk * p.S * R * ps;
  float* Wm = W;                             // m, then e^(m - M)
  float* Wl = W + p.S * Rb;                  // l
  const int n_ml = (int)p.S * Rb;
  for (int i0 = 0; i0 < n_ml; i0 += kThreads * 4) {
    float2 ml[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + tid + kThreads * u;
      if (i < n_ml) {
        const int sp = i / Rb;
        ml[u] = __ldcg(reinterpret_cast<const float2*>(
            base + (sp * R + row0 + i - sp * Rb) * ps + Dv));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + tid + kThreads * u;
      if (i < n_ml) {
        Wm[i] = ml[u].x;
        Wl[i] = ml[u].y;
      }
    }
  }
  __syncthreads();

  // 2. per row, M = max m_s and den = sum e^(m_s - M) l_s in one pass: each
  //    lane folds its splits online, then a fixed xor tree folds the lanes
  //    (the same on every lane, whatever the order the blocks finished in);
  //    the weights e^(m_s - M) replace the m_s
  for (int r = warp; r < Rb; r += NW) {
    float M = -INFINITY, den = 0.f;
    for (int sp = lane; sp < (int)p.S; sp += 32) {
      const float ms = Wm[sp * Rb + r], ls = Wl[sp * Rb + r];
      if (ms == -INFINITY) continue;         // an empty or masked split: 0
      if (ms > M) {
        den *= expf(M - ms);                 // M = -inf: den is 0 anyway
        M = ms;
      }
      den = fmaf(ls, expf(ms - M), den);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float Mo = __shfl_xor_sync(kFull, M, o);
      const float Do = __shfl_xor_sync(kFull, den, o);
      const float Mn = fmaxf(M, Mo);
      den = Mn == -INFINITY ? 0.f : den * expf(M - Mn) + Do * expf(Mo - Mn);
      M = Mn;
    }
    for (int sp = lane; sp < (int)p.S; sp += 32) {
      const float ms = Wm[sp * Rb + r];
      Wm[sp * Rb + r] = ms == -INFINITY ? 0.f : expf(ms - M);
    }
    if (lane == 0) s_den[r] = fmaxf(den, 1e-30f);
  }
  __syncthreads();

  // 3. out = sum_s w_s acc_s / den in split order, the loads of kBatch
  //    splits in flight together
  const int half = Dv / 2;                   // Dv is even: float2 columns
  const int n_units = Rb * half;
  int uoff[kUnits], urow[kUnits];
  float2 num[kUnits];
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = tid + kThreads * i;
    urow[i] = u < n_units ? u / half : 0;
    uoff[i] = (row0 + urow[i]) * (int)ps + 2 * (u - urow[i] * half);
    num[i] = make_float2(0.f, 0.f);
  }
  for (int s0 = 0; s0 < (int)p.S; s0 += kBatch) {
    float2 a[kBatch][kUnits];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int i = 0; i < kUnits; ++i)
        if (s0 + j < (int)p.S && tid + kThreads * i < n_units)
          a[j][i] = __ldcg(reinterpret_cast<const float2*>(
              base + (long long)(s0 + j) * R * ps + uoff[i]));
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int i = 0; i < kUnits; ++i)
        if (s0 + j < (int)p.S && tid + kThreads * i < n_units) {
          const float w = Wm[(s0 + j) * Rb + urow[i]];
          num[i].x = fmaf(w, a[j][i].x, num[i].x);
          num[i].y = fmaf(w, a[j][i].y, num[i].y);
        }
  }
  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int u = tid + kThreads * i;
    if (u >= n_units) continue;
    const int r = row0 + urow[i], d = 2 * (u - urow[i] * half);
    const long long qi = r / G, h = kvh * G + r % G;
    T* orow = o + ((b * p.Sq + qi) * p.H + h) * Dv;
    store(orow + d, num[i].x / s_den[urow[i]]);
    store(orow + d + 1, num[i].y / s_den[urow[i]]);
  }
  if (tid == 0) p.counter[ci] = 0;           // ready for the next launch
}

template <typename T, int DMAX, int NW>
int launch(const Params& p, cudaStream_t stream) {
  // Q (f32 and as loaded), then the tile ring, which the merge reuses for
  // its S x rows (m, l) pairs (at most NW rows a row block)
  const size_t head = NW * p.D * (sizeof(float) + sizeof(T));
  const size_t tiles =
      sizeof(T) * kStages * kTile * (p.D + 16 / sizeof(T) + p.Dv);
  const size_t ml = 2 * sizeof(float) * NW * p.S;
  const size_t smem = head + (tiles > ml ? tiles : ml);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T, DMAX, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long rows = p.Sq * (p.H / p.KV);
  const dim3 grid((unsigned)p.S, (unsigned)(p.B * p.KV),
                  (unsigned)((rows + NW - 1) / NW));
  flash_decode_kernel<T, DMAX, NW><<<grid, NW * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// a warp per query row: 4 warps for up to 4 rows (decode at G <= 4), else
// 16, in row blocks of 16 beyond
template <typename T, int DMAX>
int launch_rows(const Params& p, cudaStream_t stream) {
  const long long rows = p.Sq * (p.H / p.KV);
  if (rows <= 4) return launch<T, DMAX, 4>(p, stream);
  return launch<T, DMAX, kMaxRows>(p, stream);
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.Dv <= 32) return launch_rows<T, 32>(p, stream);     // Dv 16
  if (p.Dv <= 64) return launch_rows<T, 64>(p, stream);     // Dv 64
  if (p.Dv <= 128) return launch_rows<T, 128>(p, stream);   // Dv 128
  if (p.Dv <= 256) return launch_rows<T, 256>(p, stream);   // Dv 256
  return (int)cudaErrorInvalidValue;
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   long long B, long long Sq, long long Skv, long long H,
                   long long KV, long long D, long long Dv, long long q_start,
                   long long kv_len, long long window, int causal,
                   float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.part = nullptr; p.counter = nullptr;
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV; p.D = D; p.Dv = Dv;
  p.q_start = q_start;
  p.kv_len = kv_len < Skv ? kv_len : Skv;
  p.window = window;
  p.causal = causal;
  p.scale = scale;
  p.t0 = 0; p.tpc = 1; p.S = 1;
  p.q_pos = nullptr;
  p.q_pos_stride = 0;
  p.kv_pos = nullptr;
  p.kv_pos_stride = 0;
  return p;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted).  `part` holds (B*KV, splits, Sq*G, Dv+2) f32, `counter`
// B*KV*ceil(Sq*G/16) int32 zeros (one per (b, KV head, row block)); splits,
// the first live tile t0 and the tiles per split tpc
// by the rule above (kernels/flash_attention/kernel.py:decode_splits).
// With `q_pos` (int64 on the device) not null, q_start, kv_len and t0
// come from the device and the arguments of those names are not read
// (splits and tpc: kernel.py:capacity_splits); batch row b reads
// q_pos[b * q_pos_stride], so stride 0 gives every row one position and
// stride 1 each row its own.  With `kv_pos` (int32 on the device) not
// null, kv_len comes from kv_pos[b * kv_pos_stride] (cut to Skv) and t0
// from the device; q_start stays the argument unless q_pos is given too.
int repro_flash_decode(int is_bf16, const void* q, const void* k,
                       const void* v, void* o, void* part, void* counter,
                       long long B, long long Sq, long long Skv, long long H,
                       long long KV, long long D, long long Dv,
                       long long q_start, long long kv_len, long long window,
                       int causal, float scale, long long splits,
                       long long t0, long long tpc, const void* q_pos,
                       long long q_pos_stride, const void* kv_pos,
                       long long kv_pos_stride, void* stream) {
  Params p = make_params(q, k, v, o, B, Sq, Skv, H, KV, D, Dv, q_start,
                         kv_len, window, causal, scale);
  p.part = static_cast<float*>(part);
  p.counter = static_cast<int*>(counter);
  p.S = splits; p.t0 = t0; p.tpc = tpc;
  p.q_pos = static_cast<const long long*>(q_pos);
  p.q_pos_stride = q_pos_stride;
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.kv_pos_stride = kv_pos_stride;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(p, s) : dispatch<float>(p, s);
}

}  // extern "C"
