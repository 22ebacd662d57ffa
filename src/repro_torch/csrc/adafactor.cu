// The train step's Adafactor update, with the global-norm clip's scaling,
// for Hopper (sm_90a), with a plain C interface: three multi-tensor
// kernels, each one launch over every leaf.
//
// Replaces no Pallas kernel: `repro` leaves the update to XLA, which fuses
// it with the clip inside `jax.jit(step_fn, donate_argnums=(0,))`
// (src/repro/launch/train.py:65; src/repro/optim/adafactor.py:67-98,
// src/repro/launch/steps.py:42-50).  The port's eager step ran it as ~20
// plain launches a leaf with f32 temporaries of every leaf; these kernels
// are its counterpart of that fusion.  The clip's norm is `sumsq_kernel`
// of csrc/adamw.cu.
//
// What it computes, per leaf, in the plain version's order of operations
// (kernels/optim/ref.py:adafactor_update_torch), each f32 operation
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn; nothing contracted into an FMA) and each reciprocal square
// root by `rsqrtf`, the function `torch.rsqrt` runs on the card:
//   g   = round_to_g_dtype(g * round_to_g_dtype(scale))   (the clip)
//   g2  = g g + eps
//   factored (>= 2-D, over the last two dims; M matrices of R x C):
//     vr  = beta2 vr + (1 - beta2) (row sum of g2 / C)
//     vc  = beta2 vc + (1 - beta2) (column sum of g2 / R)
//     den = max(sum of the matrix's vr / R, eps)
//     u   = (g rsqrt(vr / den)) rsqrt(vc)
//   else: v = beta2 v + (1 - beta2) g2,  u = g rsqrt(v)
//   rms = sqrt(sum of the leaf's u u / n + eps)
//   p   = round_to_p_dtype(p - lr (u / max(rms (1 / clip), 1) + wd p))
// The sums are taken in a fixed order and never by float atomics, so two
// runs, a captured graph and an eager call give the same bits; they are
// not the plain ops' order, so the moments are held to the plain version
// within a limit and bit-equal to the order emulated in torch
// (ref.py:adafactor_update_chunked_torch).
//
// The tiling.  A factored leaf's matrices are cut into tiles of kTileRows
// x kTileCols (128 x 256) elements, tile (m, rt, ct) the tile-th of the
// leaf in that order, a block a tile.  A 1-D leaf is laid out as rows of
// kTileCols elements (its last row short), so its tiles are 32768-element
// chunks.  In a block, warp w takes the tile's rows w, w + 8, ..., w + 120
// in order and lane l its columns 8 l .. 8 l + 7 (one 16-byte load of
// bf16, two of f32, where the address allows; scalar loads otherwise: the
// arithmetic is the same).  Elements past the matrix's edge add nothing.
//   row partial of a tile's row:  each lane's 8 g2 in order, then the
//     warp's lanes by the shuffle tree (block_sum's first half);
//   column partial of a tile's column:  each warp's rows in order, then
//     the 8 warps' sums in warp order;
//   a row's sum:  its tiles' row partials in column-tile order;
//   a column's sum:  its tiles' column partials in row-tile order;
//   the sum of a matrix's vr:  thread t its rows t, t + 256, ... in order,
//     then block_sum;
//   a tile's sum of u u:  each thread's rows in order, each row's 8
//     elements in order, then block_sum;  the leaf's: thread t its tiles
//     t, t + 256, ... in order, then block_sum (as sumsq_kernel).
//
// The launches, each over the leaf table:
// adafactor_sums_kernel -- mode kFused (the step's launch): a block a
//   tile reads g once, updates a 1-D leaf's v, and writes the tile's row
//   and column partials of g2; the last tile of a row strip (an integer
//   ticket a strip, no float atomics; zeroed counters each launch) sums
//   the strip's rows and updates their vr, the last of a column strip its
//   columns' vc, and the last row strip of a matrix sums its vr (`vrsum`).
//   Under sharding the sums of a shard are partial, so the wrapper splits
//   the launch: mode kRaw writes each row's and column's sum of g2 (`sums`)
//   where kFused would update vr and vc; the wrapper reduces them across
//   ranks; mode kFinish (a block a strip, g not read) updates vr and vc
//   from them and sums each matrix's vr.
// adafactor_rms_kernel -- reads g again, recomputes u and sums u u a tile;
//   the leaf's last tile (a ticket a leaf) sums its tiles' partials
//   (`u2sum`, one f32 a leaf).
// adafactor_update_kernel -- reads g and p, recomputes u, writes p.
// The device scalars (the clip's scale, beta2 and lr: 0-d f32 tensors, so
// a replayed graph takes new values) are read on the device.
//
// What bounds it on an H100 SXM: bytes.  The update must move 6 B a bf16
// parameter (g 2, p 2 + 2; the factored moments a row and a column): 7.68
// ms at deepseek-v3-671b's 4.29 G parameters and 3.35 TB/s.  This design
// makes three passes over g, 10 B a parameter (~12.8 ms), plus the
// partials (4 B a row of a tile and a column of a tile: ~0.05 B a
// parameter).  A two-pass design would fold the sum of u u into the
// moments' pass (sum u u = den sum_j rsqrt(vc_j)^2 sum_i g2_ij / vr_i,
// given each row's vr first); this one keeps the three passes so that
// each pass repeats the plain version's roundings.
//
// The leaf table, one row of kFields int64 a leaf, built by the wrapper
// (kernels/optim/kernel.py:adafactor_rows) for each launch and passed by
// value as a __grid_constant__ kernel parameter (kMaxLeaves rows, 27 KB of
// the 32 KB a launch may carry), so nothing on the device outlives a call:
//   [0] g  [1] p  [2] vr (or v)  [3] vc       addresses (0 where unused)
//   [4] n  [5] m  [6] r  [7] c   elements, matrices, rows, columns (a 1-D
//                                leaf: 1, ceil(n / 256), 256)
//   [8] flags                    bit 0 g bf16, bit 1 p bf16, bit 2 factored
//   [9] first tile  [10] row tiles  [11] column tiles (a matrix's)
//   [12] first row strip  [13] first column strip  [14] first matrix
//   [15] the leaf's rows' sums' offset in `sums` (its columns' follow)
//   [16] the means' counts: C (low 32 bits) and R (high) of the whole
//        leaf, its shards' together  [17] n of the whole leaf
// Block b of a tile launch belongs to the last leaf whose first tile is
// <= b (a leaf's tiles, strips and matrices are prefix sums over the
// table, so a leaf that owns none shares its successor's first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;
constexpr int kTileRows = 128;
constexpr int kTileCols = 32 * kGroup;
constexpr int kMaxLeaves = 192;
constexpr int kFields = 18;
constexpr int kFused = 0, kRaw = 1, kFinish = 2;

struct Leaf {
  long long g, p, s0, s1;
  long long n, m, r, c;
  long long flags;
  long long first_tile, n_rt, n_ct;
  long long first_rstrip, first_cstrip, first_mat, sums;
  long long rc_global, n_global;
};
static_assert(sizeof(Leaf) == 8 * kFields, "the table's row");

struct Table {
  Leaf leaf[kMaxLeaves];
};
static_assert(sizeof(Table) <= 28672, "a launch's parameters");

constexpr int kFirstTile = 9, kFirstRstrip = 12, kFirstCstrip = 13;

// the last leaf whose field `f` (a prefix sum) is <= c, by bisection
__device__ __forceinline__ int find_leaf(const Leaf* leaves, int n_leaves,
                                         long long c, int f) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (reinterpret_cast<const long long*>(&leaves[mid])[f] <= c) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ bool aligned16(long long base, bool bf16,
                                          long long e) {
  return ((base + e * (bf16 ? 2 : 4)) & 15) == 0;
}

// nv (<= 8) elements of a bf16 or f32 tensor as f32 at element e, 0 past
// them: one 16-byte load of bf16 (two of f32) where all 8 are there and
// aligned, scalar loads otherwise
__device__ __forceinline__ void load8(long long base, bool bf16, long long e,
                                      int nv, float* x) {
  if (nv == kGroup && aligned16(base, bf16, e)) {
    if (bf16) {
      uint4 r = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const __nv_bfloat16*>(base) + e);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) x[k] = __bfloat162float(h[k]);
    } else {
      const float4* p = reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(base) + e);
      float4 a = p[0], b = p[1];
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (k < nv)
      x[k] = bf16 ? __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(base)[e + k])
                  : reinterpret_cast<const float*>(base)[e + k];
    else
      x[k] = 0.0f;
  }
}

__device__ __forceinline__ void store8(long long base, bool bf16,
                                       long long e, int nv, const float* x) {
  if (nv == kGroup && aligned16(base, bf16, e)) {
    if (bf16) {
      uint4 r;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) h[k] = __float2bfloat16_rn(x[k]);
      *reinterpret_cast<uint4*>(
          reinterpret_cast<__nv_bfloat16*>(base) + e) = r;
    } else {
      float4* p = reinterpret_cast<float4*>(reinterpret_cast<float*>(base)
                                            + e);
      p[0] = make_float4(x[0], x[1], x[2], x[3]);
      p[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (k < nv) {
      if (bf16)
        reinterpret_cast<__nv_bfloat16*>(base)[e + k] =
            __float2bfloat16_rn(x[k]);
      else
        reinterpret_cast<float*>(base)[e + k] = x[k];
    }
  }
}

// How many of a lane's 8 elements at row r, first column c0 (row start rb)
// lie inside the leaf: 0 past the last row, fewer at the right edge or at
// a 1-D leaf's end.
__device__ __forceinline__ int valid_count(const Leaf& lf, long long r,
                                           long long c0, long long rb) {
  if (r >= lf.r) return 0;
  long long a = lf.c - c0, b = lf.n - (rb + c0);
  long long v = a < b ? a : b;
  return v <= 0 ? 0 : (v >= kGroup ? kGroup : static_cast<int>(v));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  return x;
}

// The block's threads' values summed by a fixed tree: shuffles down within
// each warp, then warp 0 over the warps' sums.  The result is thread 0's.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = warp_sum(x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                  // red free from an earlier call
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) x = warp_sum(lane < kWarps ? red[lane] : 0.0f);
  return x;
}

__device__ __forceinline__ float rows_of(const Leaf& lf) {
  return static_cast<float>(lf.rc_global >> 32);
}
__device__ __forceinline__ float cols_of(const Leaf& lf) {
  return static_cast<float>(lf.rc_global & 0xffffffffll);
}

// The clip's scale in g's dtype (`scale.to(g.dtype)`), 1 without a clip.
__device__ __forceinline__ float clip_scale(const float* scale, bool g_bf16) {
  const float sc = scale ? *scale : 1.0f;
  return g_bf16 ? bf16_round(sc) : sc;
}

// g scaled by the clip's scale, rounded to g's dtype (`g.mul_(...)`).
__device__ __forceinline__ float scaled(float g, bool clip, float sc,
                                        bool g_bf16) {
  if (!clip) return g;
  g = __fmul_rn(g, sc);
  return g_bf16 ? bf16_round(g) : g;
}

__device__ __forceinline__ float moment(float beta2, float omb2, float v,
                                        float mean) {
  return __fadd_rn(__fmul_rn(beta2, v), __fmul_rn(omb2, mean));
}

struct Scratch {
  const float* rowpart;
  const float* colpart;
  float* sums;
  float* vrsum;
  unsigned int* mctr;
};

// The rows of matrix m's row strip rt: each row's sum of g2 (from the
// tiles' row partials in column-tile order, or, under kFinish, from
// `sums`); kRaw writes it to `sums`, the others update the row's vr and
// take the matrix's ticket: the last of its row strips sums its vr.
__device__ void finish_rows(const Leaf& lf, long long m, long long rt,
                            int mode, float beta2, float omb2,
                            const Scratch& s, float* red, int* flag) {
  const int tid = threadIdx.x;
  const long long r = rt * kTileRows + tid;
  if (tid < kTileRows && r < lf.r) {
    float a;
    if (mode == kFinish) {
      a = s.sums[lf.sums + m * lf.r + r];
    } else {
      const float* pp = s.rowpart
          + (lf.first_tile + (m * lf.n_rt + rt) * lf.n_ct) * kTileRows + tid;
      a = 0.0f;
#pragma unroll 4
      for (long long ct = 0; ct < lf.n_ct; ++ct)
        a = __fadd_rn(a, __ldcg(pp + ct * kTileRows));
    }
    if (mode == kRaw) {
      s.sums[lf.sums + m * lf.r + r] = a;
    } else {
      float* vr = reinterpret_cast<float*>(lf.s0) + m * lf.r + r;
      *vr = moment(beta2, omb2, *vr, __fdiv_rn(a, cols_of(lf)));
    }
  }
  if (mode == kRaw) return;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    *flag = atomicAdd(s.mctr + lf.first_mat + m, 1u) == lf.n_rt - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* vr = reinterpret_cast<const float*>(lf.s0) + m * lf.r;
  float a = 0.0f;
  for (long long i = tid; i < lf.r; i += kThreads)
    a = __fadd_rn(a, __ldcg(vr + i));
  a = block_sum(a, red);
  if (tid == 0) s.vrsum[lf.first_mat + m] = a;
}

// The columns of matrix m's column strip ct: each column's sum of g2 (the
// tiles' column partials in row-tile order, or `sums`); kRaw writes it,
// the others update the column's vc.
__device__ void finish_cols(const Leaf& lf, long long m, long long ct,
                            int mode, float beta2, float omb2,
                            const Scratch& s) {
  const long long c = ct * kTileCols + threadIdx.x;
  if (c >= lf.c) return;
  const long long at = lf.sums + lf.m * lf.r + m * lf.c + c;  // in sums
  float a;
  if (mode == kFinish) {
    a = s.sums[at];
  } else {
    const float* pp = s.colpart
        + (lf.first_tile + m * lf.n_rt * lf.n_ct + ct) * kTileCols
        + threadIdx.x;
    const long long stride = lf.n_ct * kTileCols;
    a = 0.0f;
#pragma unroll 4
    for (long long rt = 0; rt < lf.n_rt; ++rt)
      a = __fadd_rn(a, __ldcg(pp + rt * stride));
  }
  if (mode == kRaw) {
    s.sums[at] = a;
  } else {
    float* vc = reinterpret_cast<float*>(lf.s1) + m * lf.c + c;
    *vc = moment(beta2, omb2, *vc, __fdiv_rn(a, rows_of(lf)));
  }
}

__global__ void __launch_bounds__(kThreads)
adafactor_sums_kernel(const __grid_constant__ Table t, int n_leaves, int mode,
                      long long n_rstrips, const float* __restrict__ scale,
                      const float* __restrict__ beta2_p, float eps,
                      float* rowpart, float* colpart, float* sums,
                      float* vrsum, unsigned int* rctr, unsigned int* cctr,
                      unsigned int* mctr) {
  const Leaf* leaves = t.leaf;
  __shared__ float cols[kWarps * kTileCols];
  __shared__ float red[kWarps];
  __shared__ int flag[3];
  const float beta2 = *beta2_p, omb2 = __fsub_rn(1.0f, beta2);
  const Scratch s{rowpart, colpart, sums, vrsum, mctr};
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (mode == kFinish) {            // a block a strip, from the sums
    if (b < n_rstrips) {
      const Leaf& lf = leaves[find_leaf(leaves, n_leaves, b, kFirstRstrip)];
      const long long q = b - lf.first_rstrip;
      finish_rows(lf, q / lf.n_rt, q % lf.n_rt, mode, beta2, omb2, s, red,
                  flag + 2);
    } else {
      const long long c = b - n_rstrips;
      const Leaf& lf = leaves[find_leaf(leaves, n_leaves, c, kFirstCstrip)];
      const long long q = c - lf.first_cstrip;
      finish_cols(lf, q / lf.n_ct, q % lf.n_ct, mode, beta2, omb2, s);
    }
    return;
  }
  const Leaf& lf = leaves[find_leaf(leaves, n_leaves, b, kFirstTile)];
  const long long tl = b - lf.first_tile;
  const long long ct = tl % lf.n_ct, q = tl / lf.n_ct;
  const long long rt = q % lf.n_rt, m = q / lf.n_rt;
  const bool gb = lf.flags & 1, clip = scale != nullptr;
  const float sc = clip_scale(scale, gb);
  const long long c0 = ct * kTileCols + lane * kGroup;
  if (!(lf.flags & 4)) {            // 1-D: v = beta2 v + (1 - beta2) g2
    for (int i = warp; i < kTileRows; i += kWarps) {
      const long long r = rt * kTileRows + i, rb = r * kTileCols;
      const int nv = valid_count(lf, r, c0, rb);
      if (nv == 0) continue;
      float g[kGroup], v[kGroup];
      load8(lf.g, gb, rb + c0, nv, g);
      load8(lf.s0, false, rb + c0, nv, v);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const float x = scaled(g[k], clip, sc, gb);
        v[k] = moment(beta2, omb2, v[k], __fadd_rn(__fmul_rn(x, x), eps));
      }
      store8(lf.s0, false, rb + c0, nv, v);
    }
    return;
  }
  float col[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) col[k] = 0.0f;
  for (int i = warp; i < kTileRows; i += kWarps) {
    const long long r = rt * kTileRows + i, rb = (m * lf.r + r) * lf.c;
    const int nv = valid_count(lf, r, c0, rb);
    float g[kGroup];
    load8(lf.g, gb, rb + c0, nv, g);
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k < nv) {
        const float x = scaled(g[k], clip, sc, gb);
        const float g2 = __fadd_rn(__fmul_rn(x, x), eps);
        a = __fadd_rn(a, g2);
        col[k] = __fadd_rn(col[k], g2);
      }
    }
    a = warp_sum(a);
    if (lane == 0) rowpart[b * kTileRows + i] = a;
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    cols[warp * kTileCols + lane * kGroup + k] = col[k];
  __syncthreads();
  {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a = __fadd_rn(a, cols[w * kTileCols + tid]);
    colpart[b * kTileCols + tid] = a;
  }
  // the strips' tickets: the last tile of a row strip finishes its rows,
  // the last of a column strip its columns
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    flag[0] = atomicAdd(rctr + lf.first_rstrip + m * lf.n_rt + rt, 1u)
              == lf.n_ct - 1;
    flag[1] = atomicAdd(cctr + lf.first_cstrip + m * lf.n_ct + ct, 1u)
              == lf.n_rt - 1;
  }
  __syncthreads();
  const bool rows_last = flag[0], cols_last = flag[1];
  if (rows_last) {
    __threadfence();
    finish_rows(lf, m, rt, mode, beta2, omb2, s, red, flag + 2);
  }
  if (cols_last) {
    __threadfence();
    finish_cols(lf, m, ct, mode, beta2, omb2, s);
  }
}

// A thread's u for its 8 elements of row r (row start rb, nv of them
// there), from g scaled: u = (g rr) rc for a factored leaf, g rsqrt(v)
// for a 1-D one.
struct Factors {
  float den;                        // the matrix's max(mean vr, eps)
  float rc[kGroup];                 // rsqrt(vc) of the lane's columns
};

__device__ __forceinline__ void tile_factors(const Leaf& lf, long long m,
                                             long long c0, const float* vrsum,
                                             float eps, Factors& f) {
  if (!(lf.flags & 4)) return;
  f.den = fmaxf(__fdiv_rn(vrsum[lf.first_mat + m], rows_of(lf)), eps);
  const float* vc = reinterpret_cast<const float*>(lf.s1) + m * lf.c;
#pragma unroll
  for (int k = 0; k < kGroup; ++k)
    f.rc[k] = c0 + k < lf.c ? rsqrtf(vc[c0 + k]) : 0.0f;
}

__device__ __forceinline__ void row_u(const Leaf& lf, long long m,
                                      long long r, long long e, int nv,
                                      const Factors& f, float* u) {
  if (lf.flags & 4) {
    const float vr = reinterpret_cast<const float*>(lf.s0)[m * lf.r + r];
    const float rr = rsqrtf(__fdiv_rn(vr, f.den));
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      u[k] = __fmul_rn(__fmul_rn(u[k], rr), f.rc[k]);
  } else {
    float v[kGroup];
    load8(lf.s0, false, e, nv, v);
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      u[k] = k < nv ? __fmul_rn(u[k], rsqrtf(v[k])) : 0.0f;
  }
}

__device__ __forceinline__ long long row_start(const Leaf& lf, long long m,
                                               long long r) {
  return (lf.flags & 4) ? (m * lf.r + r) * lf.c : r * kTileCols;
}

__global__ void __launch_bounds__(kThreads)
adafactor_rms_kernel(const __grid_constant__ Table t, int n_leaves,
                     const float* __restrict__ scale,
                     const float* __restrict__ vrsum, float eps,
                     float* __restrict__ part, float* __restrict__ u2sum,
                     unsigned int* __restrict__ ctr) {
  const Leaf* leaves = t.leaf;
  __shared__ float red[kWarps];
  __shared__ bool last;
  const long long b = blockIdx.x;
  const int li = find_leaf(leaves, n_leaves, b, kFirstTile);
  const Leaf& lf = leaves[li];
  const long long tl = b - lf.first_tile;
  const long long ct = tl % lf.n_ct, q = tl / lf.n_ct;
  const long long rt = q % lf.n_rt, m = q / lf.n_rt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool gb = lf.flags & 1, clip = scale != nullptr;
  const float sc = clip_scale(scale, gb);
  const long long c0 = ct * kTileCols + lane * kGroup;
  Factors f;
  tile_factors(lf, m, c0, vrsum, eps, f);
  float acc = 0.0f;
  for (int i = warp; i < kTileRows; i += kWarps) {
    const long long r = rt * kTileRows + i, rb = row_start(lf, m, r);
    const int nv = valid_count(lf, r, c0, rb);
    if (nv == 0) continue;
    float u[kGroup];
    load8(lf.g, gb, rb + c0, nv, u);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) u[k] = scaled(u[k], clip, sc, gb);
    row_u(lf, m, r, rb + c0, nv, f, u);
#pragma unroll
    for (int k = 0; k < kGroup; ++k)
      if (k < nv) acc = __fadd_rn(acc, __fmul_rn(u[k], u[k]));
  }
  acc = block_sum(acc, red);
  if (tid == 0) {
    part[b] = acc;
    __threadfence();                // the partial lands before the count
    last = atomicAdd(ctr + li, 1u) == lf.m * lf.n_rt * lf.n_ct - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the leaf's last tile: its tiles' partials in tile order, by the tree
  const long long nt = lf.m * lf.n_rt * lf.n_ct;
  float a = 0.0f;
  for (long long i = tid; i < nt; i += kThreads)
    a = __fadd_rn(a, __ldcg(part + lf.first_tile + i));
  a = block_sum(a, red);
  if (tid == 0) u2sum[li] = a;
}

__global__ void __launch_bounds__(kThreads)
adafactor_update_kernel(const __grid_constant__ Table t, int n_leaves,
                        const float* __restrict__ scale,
                        const float* __restrict__ vrsum,
                        const float* __restrict__ u2sum,
                        const float* __restrict__ lr_p, float eps,
                        float inv_clip, float wd) {
  const Leaf* leaves = t.leaf;
  const long long b = blockIdx.x;
  const int li = find_leaf(leaves, n_leaves, b, kFirstTile);
  const Leaf& lf = leaves[li];
  const long long tl = b - lf.first_tile;
  const long long ct = tl % lf.n_ct, q = tl / lf.n_ct;
  const long long rt = q % lf.n_rt, m = q / lf.n_rt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool gb = lf.flags & 1, pb = lf.flags & 2, clip = scale != nullptr;
  const float sc = clip_scale(scale, gb);
  const float lr = *lr_p;
  const float rms = __fsqrt_rn(__fadd_rn(
      __fdiv_rn(u2sum[li], static_cast<float>(lf.n_global)), eps));
  const float d = fmaxf(__fmul_rn(rms, inv_clip), 1.0f);
  const long long c0 = ct * kTileCols + lane * kGroup;
  Factors f;
  tile_factors(lf, m, c0, vrsum, eps, f);
  for (int i = warp; i < kTileRows; i += kWarps) {
    const long long r = rt * kTileRows + i, rb = row_start(lf, m, r);
    const int nv = valid_count(lf, r, c0, rb);
    if (nv == 0) continue;
    float u[kGroup], p[kGroup];
    load8(lf.g, gb, rb + c0, nv, u);
    load8(lf.p, pb, rb + c0, nv, p);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) u[k] = scaled(u[k], clip, sc, gb);
    row_u(lf, m, r, rb + c0, nv, f, u);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float x = __fadd_rn(__fdiv_rn(u[k], d), __fmul_rn(wd, p[k]));
      p[k] = __fsub_rn(p[k], __fmul_rn(lr, x));
    }
    store8(lf.p, pb, rb + c0, nv, p);
  }
}

Table table(const void* rows, int n_leaves) {
  Table t{};
  memcpy(t.leaf, rows, sizeof(Leaf) * n_leaves);
  return t;
}

}  // namespace

extern "C" {

// The constants this library was built with: THREADS, TILE_ROWS,
// TILE_COLS, MAX_LEAVES, FIELDS.  The wrapper refuses a library whose
// constants differ from its own.
void repro_adafactor_constants(int* out) {
  out[0] = kThreads;
  out[1] = kTileRows;
  out[2] = kTileCols;
  out[3] = kMaxLeaves;
  out[4] = kFields;
}

// The moments: rows (n_leaves rows of the leaf table, host memory, copied
// into the launch); mode 0 (fused), 1 (raw sums) over n_tiles blocks, 2
// (finish, from `sums`) over n_rstrips + n_cstrips blocks; scale may be
// null (no clip); beta2 a 0-d f32 tensor on the device.  rowpart
// (n_tiles x 128 f32) and colpart (n_tiles x 256) scratch, sums (the
// rows' and columns' sums, modes 1 and 2), vrsum (one f32 a matrix,
// modes 0 and 2); rctr, cctr, mctr: one uint32 a row strip, a column
// strip, a matrix, 0 before the launch.
int repro_adafactor_sums(const void* rows, int n_leaves, int mode,
                         long long n_tiles, long long n_rstrips,
                         long long n_cstrips, const void* scale,
                         const void* beta2, float eps, void* rowpart,
                         void* colpart, void* sums, void* vrsum, void* rctr,
                         void* cctr, void* mctr, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || mode < kFused
      || mode > kFinish)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = mode == kFinish ? n_rstrips + n_cstrips : n_tiles;
  adafactor_sums_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      table(rows, n_leaves), n_leaves, mode, n_rstrips,
      static_cast<const float*>(scale), static_cast<const float*>(beta2),
      eps, static_cast<float*>(rowpart), static_cast<float*>(colpart),
      static_cast<float*>(sums), static_cast<float*>(vrsum),
      static_cast<unsigned int*>(rctr), static_cast<unsigned int*>(cctr),
      static_cast<unsigned int*>(mctr));
  return static_cast<int>(cudaGetLastError());
}

// Each leaf's sum of u u: part (n_tiles f32 scratch), u2sum (n_leaves
// f32), ctr (one uint32 a leaf, 0 before the launch).
int repro_adafactor_rms(const void* rows, int n_leaves, long long n_tiles,
                        const void* scale, const void* vrsum, float eps,
                        void* part, void* u2sum, void* ctr, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  adafactor_rms_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      table(rows, n_leaves), n_leaves, static_cast<const float*>(scale),
      static_cast<const float*>(vrsum), eps, static_cast<float*>(part),
      static_cast<float*>(u2sum), static_cast<unsigned int*>(ctr));
  return static_cast<int>(cudaGetLastError());
}

// The update of every parameter, in place: lr a 0-d f32 tensor on the
// device; inv_clip = 1 / clip_threshold in f32.
int repro_adafactor_update(const void* rows, int n_leaves, long long n_tiles,
                           const void* scale, const void* vrsum,
                           const void* u2sum, const void* lr, float eps,
                           float inv_clip, float wd, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  adafactor_update_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      table(rows, n_leaves), n_leaves, static_cast<const float*>(scale),
      static_cast<const float*>(vrsum), static_cast<const float*>(u2sum),
      static_cast<const float*>(lr), eps, inv_clip, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
