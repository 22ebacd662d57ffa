// The train step's global-norm clip and AdamW update for Hopper (sm_90a),
// with a plain C interface: two multi-tensor kernels, each one launch over
// every leaf.
//
// Replaces no Pallas kernel: `repro` leaves the clip and the update to XLA,
// which fuses them inside `jax.jit(step_fn, donate_argnums=(0,))`
// (src/repro/launch/train.py:65; src/repro/launch/steps.py:42-50,
// src/repro/optim/adamw.py:48-70).  The port's eager step ran them as ~22
// unfused launches a leaf with f32 temporaries; these two kernels are its
// counterpart of that fusion.
//
// sumsq_kernel -- the squared sum of every gradient leaf in f32, one f32 a
//   leaf.  Leaves are bf16 or f32, each element read in its own dtype and
//   squared in f32.  The work is cut into chunks of kChunk elements of one
//   leaf, a block a chunk.  A thread owns groups of 8 neighbouring elements
//   (groups tid, tid + kThreads, ...), summing each group's squares in
//   element order into one f32 accumulator; the block's threads are summed
//   by a fixed tree (shuffles, then warp 0 over the warps) into the chunk's
//   partial.  The last block to finish (an integer counter, no float
//   atomics; the caller hands each launch a zeroed counter) sums each
//   leaf's partials in chunk order by the same fixed tree.  So the sums depend only on the elements:
//   two runs, a captured graph and an eager call give the same bits.  A
//   group is one 16-byte load where the chunk's address allows it, else
//   eight scalar loads; the arithmetic and its order are the same.
//
// adamw_update_kernel -- the clip's scaling and the AdamW update of every
//   leaf, in place: reads g, p, m, v and the 0-d device scalars (the clip
//   scale, lr, bc1, bc2: read on the device, so a replayed graph takes new
//   values), writes p, m, v.  Per element, in the port's order of
//   operations (launch/steps.py's `g.mul_(scale.to(g.dtype))`, then
//   optim/adamw.py), every f32 operation rounded on its own (__fmul_rn,
//   __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn; nothing contracted into
//   an FMA):
//     g' = round_to_g_dtype(g * round_to_g_dtype(scale))
//     m  = b1 m + (1 - b1) g'
//     v  = b2 v + ((1 - b2) g') g'
//     u  = (m / bc1) / (sqrt(v / bc2) + eps) + wd p
//     p  = round_to_p_dtype(p - lr u)
//   bit-equal to the plain torch ops, which round each op the same way.
//   Groups of 8 elements as 16-byte loads and stores where all four
//   tensors' addresses at the chunk's start allow it, scalar otherwise; the
//   chunk's tail (count % 8) scalar.
//
// What bounds them on an H100 SXM: bytes.  sumsq reads each gradient
// element once (2 B in bf16); the update moves 22 B a bf16 parameter (g 2,
// p 2 + 2, m 4 + 4, v 4 + 4).  At llama3.2-1b's 1.24 G parameters that is
// 0.74 ms and 8.1 ms at 3.35 TB/s.  Both kernels stream: 16-byte loads, a
// block of 256 threads a 32768-element chunk (tens of thousands of blocks
// at llama's width), no shared-memory staging; the update holds a group's
// 8 elements of four tensors in registers.
//
// The leaf table, one row of 8 int64 a leaf, built by the wrapper
// (kernels/optim/kernel.py:leaf_rows) for each launch and passed by value as
// a __grid_constant__ kernel parameter (Table: kMaxLeaves rows, 28 KB of
// the 32 KB a launch may carry, the first n_leaves filled), so the launch --
// or the graph node a capture makes of it -- holds its own copy and nothing
// on the device has to outlive the call:
//   [0] g  [1] p  [2] m  [3] v   addresses (p, m, v unused by sumsq)
//   [4] n                        elements
//   [5] g's dtype, [6] p's dtype 0 f32, 1 bf16 (m and v are f32)
//   [7] first                    the leaf's first chunk
// Chunk c belongs to the last leaf whose first chunk is <= c (leaves of no
// element own no chunk); it covers elements [(c - first) * kChunk, +
// min(kChunk, n - that)) of its leaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 32768;
constexpr int kGroup = 8;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLeaves = 448;

struct Leaf {
  long long g, p, m, v, n, gtype, ptype, first;
};

struct Table {
  Leaf leaf[kMaxLeaves];
};
static_assert(sizeof(Table) <= 28672, "a launch's parameters");

__device__ __forceinline__ int find_leaf(const Leaf* leaves, int n_leaves,
                                         long long c) {
  // the last leaf whose first chunk is <= c, by bisection (a leaf of no
  // element shares its successor's first chunk, so it is never the last)
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].first <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// eight elements of a bf16 or f32 leaf as f32, at element e (aligned: one
// 16-byte load of bf16, two of f32)
__device__ __forceinline__ void load8(long long base, long long type,
                                      long long e, bool vec, float* x) {
  if (type) {
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(base) + e;
    if (vec) {
      uint4 r = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) x[k] = __bfloat162float(h[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) x[k] = __bfloat162float(p[k]);
    }
  } else {
    const float* p = reinterpret_cast<const float*>(base) + e;
    if (vec) {
      float4 a = reinterpret_cast<const float4*>(p)[0];
      float4 b = reinterpret_cast<const float4*>(p)[1];
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) x[k] = p[k];
    }
  }
}

__device__ __forceinline__ void store8(long long base, long long type,
                                       long long e, bool vec,
                                       const float* x) {
  if (type) {
    __nv_bfloat16* p = reinterpret_cast<__nv_bfloat16*>(base) + e;
    if (vec) {
      uint4 r;
      __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
      for (int k = 0; k < kGroup; ++k) h[k] = __float2bfloat16_rn(x[k]);
      *reinterpret_cast<uint4*>(p) = r;
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) p[k] = __float2bfloat16_rn(x[k]);
    }
  } else {
    float* p = reinterpret_cast<float*>(base) + e;
    if (vec) {
      reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
      reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) p[k] = x[k];
    }
  }
}

__device__ __forceinline__ float load1(long long base, long long type,
                                       long long e) {
  return type ? __bfloat162float(
                    reinterpret_cast<const __nv_bfloat16*>(base)[e])
              : reinterpret_cast<const float*>(base)[e];
}

__device__ __forceinline__ void store1(long long base, long long type,
                                       long long e, float x) {
  if (type)
    reinterpret_cast<__nv_bfloat16*>(base)[e] = __float2bfloat16_rn(x);
  else
    reinterpret_cast<float*>(base)[e] = x;
}

__device__ __forceinline__ bool aligned16(long long base, long long type,
                                          long long e) {
  return ((base + e * (type ? 2 : 4)) & 15) == 0;
}

// The block's threads' values summed by a fixed tree: shuffles down within
// each warp, then warp 0 over the warps' sums.  The result is thread 0's.
__device__ __forceinline__ float block_sum(float x, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                  // smem free from an earlier call
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? smem[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const __grid_constant__ Table t, int n_leaves,
             float* __restrict__ partials, float* __restrict__ out,
             unsigned int* __restrict__ counter) {
  const Leaf* leaves = t.leaf;
  __shared__ float smem[kWarps];
  __shared__ bool last;
  const long long c = blockIdx.x;
  const Leaf lf = leaves[find_leaf(leaves, n_leaves, c)];
  const long long start = (c - lf.first) * kChunk;
  const long long count = min(kChunk, lf.n - start);
  const long long groups = count / kGroup;
  const bool vec = aligned16(lf.g, lf.gtype, start);
  float acc = 0.0f;
  for (long long j = threadIdx.x; j < groups; j += kThreads) {
    float x[kGroup];
    load8(lf.g, lf.gtype, start + j * kGroup, vec, x);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) acc = __fadd_rn(acc, __fmul_rn(x[k], x[k]));
  }
  // the ragged tail: the thread that would own the next group, in order
  if (threadIdx.x == groups % kThreads) {
    for (long long e = start + groups * kGroup; e < start + count; ++e) {
      const float x = load1(lf.g, lf.gtype, e);
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
  }
  acc = block_sum(acc, smem);
  if (threadIdx.x == 0) {
    partials[c] = acc;
    __threadfence();                // the partial lands before the count
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: each leaf's partials in chunk order, by the same tree
  for (int l = 0; l < n_leaves; ++l) {
    const long long first = leaves[l].first;
    const long long n_chunks = (leaves[l].n + kChunk - 1) / kChunk;
    float a = 0.0f;
    for (long long i = threadIdx.x; i < n_chunks; i += kThreads)
      a = __fadd_rn(a, __ldcg(partials + first + i));
    a = block_sum(a, smem);
    if (threadIdx.x == 0) out[l] = a;
  }
}

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw_one(float g, float& p, float& m,
                                          float& v, bool clip, float sc,
                                          bool g_bf16, float lr, float bc1,
                                          float bc2, const Hyper& h) {
  if (clip) {
    g = __fmul_rn(g, sc);
    if (g_bf16) g = bf16_round(g);
  }
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
  u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, u));
}

__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Table t, int n_leaves,
                    const float* __restrict__ scale,
                    const float* __restrict__ lr_p,
                    const float* __restrict__ bc1_p,
                    const float* __restrict__ bc2_p, Hyper h) {
  const Leaf* leaves = t.leaf;
  const long long c = blockIdx.x;
  const Leaf lf = leaves[find_leaf(leaves, n_leaves, c)];
  const long long start = (c - lf.first) * kChunk;
  const long long count = min(kChunk, lf.n - start);
  const long long groups = count / kGroup;
  const bool clip = scale != nullptr;
  const bool g_bf16 = lf.gtype != 0;
  float sc = clip ? *scale : 1.0f;
  if (g_bf16) sc = bf16_round(sc);    // scale.to(g.dtype)
  const float lr = *lr_p, bc1 = *bc1_p, bc2 = *bc2_p;
  const bool vec = aligned16(lf.g, lf.gtype, start)
                   && aligned16(lf.p, lf.ptype, start)
                   && aligned16(lf.m, 0, start) && aligned16(lf.v, 0, start);
  if (vec) {
    for (long long j = threadIdx.x; j < groups; j += kThreads) {
      const long long e = start + j * kGroup;
      float g[kGroup], p[kGroup], m[kGroup], v[kGroup];
      load8(lf.g, lf.gtype, e, true, g);
      load8(lf.p, lf.ptype, e, true, p);
      load8(lf.m, 0, e, true, m);
      load8(lf.v, 0, e, true, v);
#pragma unroll
      for (int k = 0; k < kGroup; ++k)
        adamw_one(g[k], p[k], m[k], v[k], clip, sc, g_bf16, lr, bc1, bc2, h);
      store8(lf.p, lf.ptype, e, true, p);
      store8(lf.m, 0, e, true, m);
      store8(lf.v, 0, e, true, v);
    }
  }
  // scalar: the whole chunk where an address is not 16-byte aligned, else
  // the tail past the last whole group
  for (long long e = start + (vec ? groups * kGroup : 0) + threadIdx.x;
       e < start + count; e += kThreads) {
    float p = load1(lf.p, lf.ptype, e), m = load1(lf.m, 0, e),
          v = load1(lf.v, 0, e);
    adamw_one(load1(lf.g, lf.gtype, e), p, m, v, clip, sc, g_bf16, lr, bc1,
              bc2, h);
    store1(lf.p, lf.ptype, e, p);
    store1(lf.m, 0, e, m);
    store1(lf.v, 0, e, v);
  }
}

Table table(const void* rows, int n_leaves) {
  Table t{};
  memcpy(t.leaf, rows, sizeof(Leaf) * n_leaves);
  return t;
}

}  // namespace

extern "C" {

// The constants this library was built with: THREADS, CHUNK, MAX_LEAVES.
// The wrapper refuses a library whose constants differ from its own.
void repro_adamw_constants(int* out) {
  out[0] = kThreads;
  out[1] = static_cast<int>(kChunk);
  out[2] = kMaxLeaves;
}

// Per-leaf squared sums: rows (n_leaves rows of the leaf table, host
// memory, copied into the launch), n_chunks blocks, partials (n_chunks f32
// scratch), out (n_leaves f32), counter (one uint32, 0 before the launch).
int repro_sumsq(const void* rows, int n_leaves, long long n_chunks,
                void* partials, void* out, void* counter, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  sumsq_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      table(rows, n_leaves), n_leaves, static_cast<float*>(partials),
      static_cast<float*>(out), static_cast<unsigned int*>(counter));
  return static_cast<int>(cudaGetLastError());
}

// The clip's scaling and the AdamW update, in place: rows as repro_sumsq's;
// scale may be null (no clip); lr, bc1, bc2 are 0-d f32 tensors on the
// device.
int repro_adamw_update(const void* rows, int n_leaves, long long n_chunks,
                       const void* scale, const void* lr, const void* bc1,
                       const void* bc2, float b1, float omb1, float b2,
                       float omb2, float eps, float wd, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  Hyper h{b1, omb1, b2, omb2, eps, wd};
  adamw_update_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table(rows, n_leaves), n_leaves, static_cast<const float*>(scale),
      static_cast<const float*>(lr), static_cast<const float*>(bc1),
      static_cast<const float*>(bc2), h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
