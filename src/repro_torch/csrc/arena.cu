// The four arena ops of repro_torch, written by hand for Hopper (sm_90a).
//
// One linear arena buffer holds every intermediate tensor of a scheduled
// graph at the element offsets of its ArenaPlan (DESIGN.md §6).  These
// kernels move tensors in and out of it, in place, touching only
// [offset, offset + n):
//
//   write        arena[o:o+n] = x                         (f32 and u8)
//   read         out = arena[o:o+n], a fresh buffer       (f32 and u8)
//   accum        arena[o:o+n] += x                        (f32)
//   chain_write  arena[o:o+n] = ops[k-1](...ops[0](x))    (f32)
//
// Built with nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/arena/kernel.py).  Every entry launches
// on the caller's stream, allocates nothing, does not synchronise, and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// What bounds them on an H100 SXM: each op moves a few bytes per element
// and does at most a few dozen flops on it, so the roofline bound is bytes
// over 3.35 TB/s.  At the paper networks' f32 tensors (about 100 KB a
// launch) that is ~0.06 us, far below the ~0.83 us that a launch of the
// copy's grid costs on the card with no load or store at all
// (tools/arena_copy_probe.py, variant empty), so the launch and one
// L2 round trip for the load and one for the store bound them, and the
// host loop that issues them bounds the program.  At the served
// decode-state leaves (u8, 10 KB to 33.5 MB a leaf; 17.3 MB for each of
// llama3.2-1b's K and V) write and read are DRAM streams: 10.33 us of
// bound for one llama leaf.
//
// Write and read are one byte copy, dst[0:nbytes] = src[0:nbytes]
// (arena + o*esz <- x, or out <- arena + o*esz), for f32 and u8 alike.
// The wrapper splits it by copy_plan (kernels/arena/kernel.py) into a
// head of at most 15 bytes up to the first 16-byte-aligned destination
// address, a body of 16-byte stores, and a tail of at most 15 bytes; the
// source's phase against the destination, (src - dst) mod 16, picks how
// each 16-byte store is built (one kernel instance a phase class):
//   phase 0      one aligned 16-byte load (every served leaf);
//   other phase  the two aligned 16-byte loads that hold its 16 source
//                bytes, joined by __funnelshift_r (a word select when the
//                phase is a multiple of 4, as for every other f32 call).
// Both loads of a shifted store lie in 16-byte blocks that hold source
// bytes, so nothing outside the source's own 16-byte blocks is read.
// Each thread issues kLoads 16-byte loads before its stores, through the
// non-coherent path (the source is never written within a launch: the
// wrapper refuses an x that shares the arena's storage, and out is
// fresh).  The grid is one store a thread up to one resident wave
// (kMaxBlocks), with a grid-stride loop beyond, so a small copy spreads
// over as many SMs as it fills.  Stores are evict-first: a packed leaf is
// read back only after a whole decode step has streamed the weights
// through L2, an unpacked leaf is read once by its layer, and the
// executor's arena is far smaller than L2, so nothing waits on a line
// they give up first; at Griffin's small leaves they are faster.  The head
// and tail bytes are moved by the first 32 threads of block 0, loaded
// before the body and stored after it.  tools/arena_copy_probe.py times
// the variants this design was chosen over (PERF.md §6).
//
// accum, arena[o:o+n] += x, is the same split over f32: the wrapper passes
// copy_plan(arena + 4 o, x, 4 n), so the head and the tail are at most 3
// floats each and the body is float4 read-modify-writes at 16-byte-aligned
// arena addresses.  x's phase against the arena is a multiple of 4 bytes:
// phase 0 is one aligned load of x, any other the two aligned loads that
// join<W> selects words from (bits 0).  The add is four __fadd_rn a vector,
// bit-equal to torch's add_.  The arena is read and written in the same
// launch, so its loads skip L1 (__ldcg), never the non-coherent path; x
// keeps __ldg.  Stores are plain: the next node reads the accumulated
// slice soon after.  The grid is launch_mode's (one vector a thread up to
// one wave), kAccVecs vectors a thread a pass beyond it.  The mean launch
// of a darts_net_x6 execute is ~37,700 floats (0.135 us of bytes), so the
// launch and two L2 round trips set its time, as for the f32 copies.
//
// chain_write, arena[o:o+n] = ops[k-1](...ops[0](x)), is the same split
// again: copy_plan(arena + 4 o, x, 4 n), x loaded at its phase as accum
// loads it, the chain applied to the four floats in registers, one
// dispatch an op for all four, each by the same op_of as one float (so
// the ops and their rounding are the plain version's; a dispatch a float
// made the kernel slower than the one-float kernel it replaces), float4
// stores at 16-byte-aligned arena addresses, and the grid launch_mode's.
// The ops travel packed in a 64-bit code (indexing the kernel's
// parameters at run time put a copy of them in local memory), and a chain
// of exact ops only runs an instance with no transcendental code (-0.06 us
// a launch at the darts chains; tools/arena_copy_probe.py, chain_*
// variants).  A fused chain costs one launch and touches only the slice
// (the Pallas kernels copy the whole arena through, which exists only for
// their interpret mode).  Its stores are plain, as accum's: the next node
// reads the slice soon after.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// one resident wave of the copy's grid (8 blocks of 256 on each of 132
// SMs); the grid-stride loop covers any longer slice
constexpr long long kMaxBlocks = 132LL * 8;

constexpr int kMaxChain = 16;  // MAX_CHAIN in kernels/arena/elemwise.py

// the copy: threads a block (8 blocks an SM at 32 registers), 16-byte
// loads in flight a thread, and the type of its store indices
constexpr int kCopyThreads = 256;
constexpr int kLoads = 2;
using Index = long long;
// accum: float4 read-modify-writes a thread in one pass of the grid (2
// and 4 spill at the launch bounds' 32 registers, tools/arena_copy_probe.py)
constexpr int kAccVecs = 1;

// must match ELEMWISE_OP_CODES in kernels/arena/elemwise.py
enum ElemOp : int {
  OP_IDENTITY = 0,
  OP_RELU = 1,
  OP_RELU6 = 2,
  OP_BN = 3,
  OP_SIGMOID = 4,
  OP_TANH = 5,
  OP_GELU = 6,
  OP_SILU = 7,
  OP_BIAS_ADD = 8,
  OP_SCALE = 9,
};

}  // namespace

// The chain as the C entry takes it (by value: no device copy of the op
// list, no extra launch); the launch packs it into a Chain.
struct ChainOps {
  int n;
  int op[kMaxChain];
};

namespace {

// The split of one copy, computed by copy_plan in kernels/arena/kernel.py:
// head bytes, then nvec 16-byte stores from the first 16-byte-aligned
// destination address on, then tail bytes; phase = (src - dst) mod 16.
struct CopyPlan {
  long long head;
  long long nvec;
  long long tail;
  int phase;
};

__device__ __forceinline__ uint4 load16(const uint4* p) { return __ldg(p); }

__device__ __forceinline__ void store16(uint4* p, uint4 v) { __stcs(p, v); }

// bytes [4W + bits/8, 4W + bits/8 + 16) of the 32 bytes a:b
template <int W>
__device__ __forceinline__ uint4 join(uint4 a, uint4 b, unsigned int bits) {
  const unsigned int w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  return make_uint4(__funnelshift_r(w[W], w[W + 1], bits),
                    __funnelshift_r(w[W + 1], w[W + 2], bits),
                    __funnelshift_r(w[W + 2], w[W + 3], bits),
                    __funnelshift_r(w[W + 3], w[W + 4], bits));
}

// Replaces arena_write_pallas / _write_kernel and arena_read_pallas /
// _read_kernel (src/repro/kernels/arena/kernel.py): dst[0:nbytes] =
// src[0:nbytes] split by p.  Bound: 2*nbytes over 3.35 TB/s.
//
// kMode 0 is phase 0: store i takes source vector i.  kMode 1 + W is any
// other phase: s is the source body rounded down to 16 bytes, and store i
// joins aligned source vectors i and i + 1 at word W and bit shift bits.
// A thread issues kLoads 16-byte loads (kStores stores' worth) before
// their stores, and each warp instruction covers 512 contiguous bytes.
// The edge bytes are loaded before and stored after the body, so that no
// load of the body waits on them.
template <int kMode>
__device__ __forceinline__ void copy_bytes(
    unsigned char* dst, const unsigned char* __restrict__ src,
    const CopyPlan& p) {
  long long edge = -1;
  unsigned char e = 0;
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const int t = threadIdx.x;
    if (t < p.head) {
      edge = t;
    } else if (t >= 16 && t - 16 < p.tail) {
      edge = p.head + 16 * p.nvec + (t - 16);
    }
    if (edge >= 0) e = src[edge];
  }
  uint4* d = reinterpret_cast<uint4*>(dst + p.head);
  const unsigned char* s = src + p.head;
  // Thread t of the grid takes stores t, t + step, ... (step = the grid's
  // threads), kStores of them a pass: a small copy is one store a thread,
  // spread over as many SMs as it fills.
  constexpr int kStores = kMode == 0 || kLoads == 1 ? kLoads : kLoads / 2;
  const Index n = static_cast<Index>(p.nvec);
  const Index step = static_cast<Index>(gridDim.x) * kCopyThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kCopyThreads + threadIdx.x;
       i < n; i += step * kStores) {
    if constexpr (kMode == 0) {
      const uint4* sv = reinterpret_cast<const uint4*>(s);
      uint4 v[kStores];
#pragma unroll
      for (int k = 0; k < kStores; ++k) {
        if (i + k * step < n) v[k] = load16(sv + i + k * step);
      }
#pragma unroll
      for (int k = 0; k < kStores; ++k) {
        if (i + k * step < n) store16(d + i + k * step, v[k]);
      }
    } else {
      const uint4* sa = reinterpret_cast<const uint4*>(s - p.phase);
      const unsigned int bits = 8u * (p.phase & 3);
      uint4 a[kStores], b[kStores];
#pragma unroll
      for (int k = 0; k < kStores; ++k) {
        if (i + k * step < n) {
          a[k] = load16(sa + i + k * step);
          b[k] = load16(sa + i + k * step + 1);
        }
      }
#pragma unroll
      for (int k = 0; k < kStores; ++k) {
        if (i + k * step < n) {
          store16(d + i + k * step, join<kMode - 1>(a[k], b[k], bits));
        }
      }
    }
  }
  if (edge >= 0) dst[edge] = e;
}

// Two names for the one copy, so that a trace tells write from read.
template <int kMode>
__global__ void __launch_bounds__(kCopyThreads, 2048 / kCopyThreads)
    arena_write_kernel(unsigned char* arena_at,
                       const unsigned char* __restrict__ x, CopyPlan p) {
  copy_bytes<kMode>(arena_at, x, p);
}

template <int kMode>
__global__ void __launch_bounds__(kCopyThreads, 2048 / kCopyThreads)
    arena_read_kernel(unsigned char* out,
                      const unsigned char* __restrict__ arena_at,
                      CopyPlan p) {
  copy_bytes<kMode>(out, arena_at, p);
}

__device__ __forceinline__ float4 load_arena(const float4* p) {
  return __ldcg(p);
}

__device__ __forceinline__ void store_arena(float4* p, float4 v) { *p = v; }

__device__ __forceinline__ float4 add4(float4 a, uint4 b) {
  return make_float4(__fadd_rn(a.x, __uint_as_float(b.x)),
                     __fadd_rn(a.y, __uint_as_float(b.y)),
                     __fadd_rn(a.z, __uint_as_float(b.z)),
                     __fadd_rn(a.w, __uint_as_float(b.w)));
}

// Replaces arena_accum_pallas / _accum_kernel: the rewritten partial-conv
// step, dst[0:n] += x[0:n] split by p (in bytes, as for the copy).  Bound:
// 3*n*4 bytes (slice read, x read, slice written).  kW is x's phase in
// words, (x - dst) mod 16 / 4: 0 loads vector i of x, any other joins the
// aligned vectors i and i + 1 that hold its 16 bytes.  The edge floats (at
// most 3 a side) are loaded by the first threads of block 0 before the
// body and stored after it.
template <int kW>
__global__ void __launch_bounds__(kCopyThreads, 2048 / kCopyThreads)
    accum_kernel(float* dst, const float* __restrict__ x, CopyPlan p) {
  long long edge = -1;
  float e = 0.f;
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int t = threadIdx.x;
    const long long head = p.head / 4, tail = p.tail / 4;
    if (t < head) {
      edge = t;
    } else if (t >= 4 && t - 4 < tail) {
      edge = head + 4 * p.nvec + (t - 4);
    }
    if (edge >= 0) e = __fadd_rn(__ldcg(dst + edge), x[edge]);
  }
  float4* d = reinterpret_cast<float4*>(
      reinterpret_cast<unsigned char*>(dst) + p.head);
  const uint4* xs = reinterpret_cast<const uint4*>(
      reinterpret_cast<const unsigned char*>(x) + p.head - p.phase);
  const Index n = static_cast<Index>(p.nvec);
  const Index grid = static_cast<Index>(gridDim.x) * kCopyThreads;
  for (Index i = threadIdx.x + static_cast<Index>(blockIdx.x) * kCopyThreads;
       i < n; i += grid * kAccVecs) {
    float4 a[kAccVecs];
    uint4 b[kAccVecs];
#pragma unroll
    for (int k = 0; k < kAccVecs; ++k) {
      const Index j = i + k * grid;
      if (j < n) {
        a[k] = load_arena(d + j);
        if constexpr (kW == 0) {
          b[k] = __ldg(xs + j);
        } else {
          b[k] = join<kW>(__ldg(xs + j), __ldg(xs + j + 1), 0u);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kAccVecs; ++k) {
      const Index j = i + k * grid;
      if (j < n) store_arena(d + j, add4(a[k], b[k]));
    }
  }
  if (edge >= 0) dst[edge] = e;
}

// The unary ops of ELEMWISE_FNS.  relu, relu6, bn, bias_add and scale use
// the same arithmetic as torch's eager CUDA kernels, with _rn intrinsics so
// no FMA contraction separates them: bit-equal.  The transcendentals follow
// torch's formulas with expf/tanhf: allclose.
template <int kOp>
__device__ __forceinline__ float op_of(float v) {
  if constexpr (kOp == OP_RELU) {
    return isnan(v) ? v : fmaxf(v, 0.0f);
  } else if constexpr (kOp == OP_RELU6) {
    return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 6.0f);
  } else if constexpr (kOp == OP_BN) {
    return __fsub_rn(__fmul_rn(v, 1.05f), 0.02f);
  } else if constexpr (kOp == OP_SIGMOID) {
    return 1.0f / (1.0f + expf(-v));
  } else if constexpr (kOp == OP_TANH) {
    return tanhf(v);
  } else if constexpr (kOp == OP_GELU) {
    // tanh form, as jax.nn.gelu's default and F.gelu(approximate="tanh")
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float inner = kBeta * (v + kKappa * (v * v * v));
    return 0.5f * v * (1.0f + tanhf(inner));
  } else if constexpr (kOp == OP_SILU) {
    return v / (1.0f + expf(-v));
  } else if constexpr (kOp == OP_BIAS_ADD) {
    return __fadd_rn(v, 0.05f);
  } else if constexpr (kOp == OP_SCALE) {
    return __fmul_rn(v, 0.9f);
  } else {  // identity, dropout (inference), cast_inplace
    return v;
  }
}

template <int kOp, int N>
__device__ __forceinline__ void map_op(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = op_of<kOp>(v[i]);
}

// A chain as the kernel takes it: op k in bits 4k .. 4k + 3 of code, so
// that no thread indexes the kernel's parameters at run time (which puts
// a copy of them in local memory).
struct Chain {
  unsigned long long code;
  int n;
};

__host__ __device__ constexpr bool exact_op(int op) {
  return op != OP_SIGMOID && op != OP_TANH && op != OP_GELU && op != OP_SILU;
}

// An exact op on each of the N floats of v (the identities do nothing).
template <int N>
__device__ __forceinline__ void apply_exact(int op, float (&v)[N]) {
  switch (op) {
    case OP_RELU: map_op<OP_RELU>(v); break;
    case OP_RELU6: map_op<OP_RELU6>(v); break;
    case OP_BN: map_op<OP_BN>(v); break;
    case OP_BIAS_ADD: map_op<OP_BIAS_ADD>(v); break;
    case OP_SCALE: map_op<OP_SCALE>(v); break;
    default: break;
  }
}

// Any op on each of the N floats of v.
template <int N>
__device__ __forceinline__ void apply_any(int op, float (&v)[N]) {
  switch (op) {
    case OP_SIGMOID: map_op<OP_SIGMOID>(v); break;
    case OP_TANH: map_op<OP_TANH>(v); break;
    case OP_GELU: map_op<OP_GELU>(v); break;
    case OP_SILU: map_op<OP_SILU>(v); break;
    default: apply_exact(op, v); break;
  }
}

// The chain on each of the N floats of v, op by op: one dispatch an op for
// all N (the chain is the launch's, so every thread takes the same case).
// With kExact (a chain of exact ops only) the kernel holds neither the
// transcendental ops' code nor their cases (tools/arena_copy_probe.py,
// chain_general, measures what they cost).
template <bool kExact, int N>
__device__ __forceinline__ void apply_chain(const Chain& c, float (&v)[N]) {
  unsigned long long code = c.code;
  for (int k = 0; k < c.n; ++k, code >>= 4) {
    const int op = static_cast<int>(code & 15);
    if constexpr (kExact) {
      apply_exact(op, v);
    } else {
      apply_any(op, v);
    }
  }
}

// Replaces arena_chain_write_pallas / _chain_write_kernel: a whole in-place
// alias chain in one launch, dst[0:n] = chain(x[0:n]) split by p (in
// bytes, as for accum).  Bound: 2*n*4 bytes; the chain's flops (a few
// dozen per element at most) are far below the card's 67 TFLOP/s f32
// rate.  kW is x's phase in words, as for accum; kExact says every op of
// the chain is exact.  The running values stay in registers from the first
// op to the store; the edge floats (at most 3 a side) are loaded and
// chained by the first threads of block 0 before the body and stored after
// it.
template <int kW, bool kExact>
__global__ void __launch_bounds__(kCopyThreads, 2048 / kCopyThreads)
    chain_write_kernel(float* dst, const float* __restrict__ x, CopyPlan p,
                       Chain ops) {
  long long edge = -1;
  float e = 0.f;
  if (blockIdx.x == 0 && threadIdx.x < 8) {
    const int t = threadIdx.x;
    const long long head = p.head / 4, tail = p.tail / 4;
    if (t < head) {
      edge = t;
    } else if (t >= 4 && t - 4 < tail) {
      edge = head + 4 * p.nvec + (t - 4);
    }
    if (edge >= 0) {
      float v[1] = {x[edge]};
      apply_chain<kExact>(ops, v);
      e = v[0];
    }
  }
  float4* d = reinterpret_cast<float4*>(
      reinterpret_cast<unsigned char*>(dst) + p.head);
  const uint4* xs = reinterpret_cast<const uint4*>(
      reinterpret_cast<const unsigned char*>(x) + p.head - p.phase);
  const Index n = static_cast<Index>(p.nvec);
  const Index grid = static_cast<Index>(gridDim.x) * kCopyThreads;
  for (Index i = threadIdx.x + static_cast<Index>(blockIdx.x) * kCopyThreads;
       i < n; i += grid) {
    uint4 b;
    if constexpr (kW == 0) {
      b = __ldg(xs + i);
    } else {
      b = join<kW>(__ldg(xs + i), __ldg(xs + i + 1), 0u);
    }
    float v[4] = {__uint_as_float(b.x), __uint_as_float(b.y),
                  __uint_as_float(b.z), __uint_as_float(b.w)};
    apply_chain<kExact>(ops, v);
    store_arena(d + i, make_float4(v[0], v[1], v[2], v[3]));
  }
  if (edge >= 0) dst[edge] = e;
}

// The plan must split exactly nbytes, with the body's stores 16-byte
// aligned and the phase of these two addresses: anything else would store
// out of place or fault, so it is refused before the launch.
bool plan_fits(const unsigned char* dst, const unsigned char* src,
               long long nbytes, const CopyPlan& p) {
  const unsigned long long d = reinterpret_cast<unsigned long long>(dst);
  const unsigned long long s = reinterpret_cast<unsigned long long>(src);
  return p.head >= 0 && p.head < 16 && p.tail >= 0 && p.tail < 16 &&
         p.nvec >= 0 && p.head + 16 * p.nvec + p.tail == nbytes &&
         (p.nvec == 0 || (d + p.head) % 16 == 0) &&
         p.phase == static_cast<int>((s - d) & 15);
}

// One store a thread up to kMaxBlocks (the launch bounds keep 8 blocks
// resident on each SM: one wave), then the grid-stride loop.
template <int kMode, bool kRead>
int launch_mode(unsigned char* d, const unsigned char* s, const CopyPlan& p,
                cudaStream_t st) {
  const long long want = (p.nvec + kCopyThreads - 1) / kCopyThreads;
  const unsigned int blocks = static_cast<unsigned int>(
      want < 1 ? 1 : (want < kMaxBlocks ? want : kMaxBlocks));
  if (kRead) {
    arena_read_kernel<kMode><<<blocks, kCopyThreads, 0, st>>>(d, s, p);
  } else {
    arena_write_kernel<kMode><<<blocks, kCopyThreads, 0, st>>>(d, s, p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kRead>
int launch_phase(unsigned char* d, const unsigned char* s, const CopyPlan& p,
                 cudaStream_t st) {
  switch (p.phase == 0 ? 0 : 1 + (p.phase >> 2)) {
    case 0: return launch_mode<0, kRead>(d, s, p, st);
    case 1: return launch_mode<1, kRead>(d, s, p, st);
    case 2: return launch_mode<2, kRead>(d, s, p, st);
    case 3: return launch_mode<3, kRead>(d, s, p, st);
    default: return launch_mode<4, kRead>(d, s, p, st);
  }
}

template <int kW>
int launch_accum(float* d, const float* x, const CopyPlan& p,
                 cudaStream_t st) {
  const long long want = (p.nvec + kCopyThreads - 1) / kCopyThreads;
  const unsigned int blocks = static_cast<unsigned int>(
      want < 1 ? 1 : (want < kMaxBlocks ? want : kMaxBlocks));
  accum_kernel<kW><<<blocks, kCopyThreads, 0, st>>>(d, x, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kW, bool kExact>
int launch_chain_k(float* d, const float* x, const CopyPlan& p,
                   const Chain& ops, cudaStream_t st) {
  const long long want = (p.nvec + kCopyThreads - 1) / kCopyThreads;
  const unsigned int blocks = static_cast<unsigned int>(
      want < 1 ? 1 : (want < kMaxBlocks ? want : kMaxBlocks));
  chain_write_kernel<kW, kExact><<<blocks, kCopyThreads, 0, st>>>(d, x, p,
                                                                  ops);
  return static_cast<int>(cudaGetLastError());
}

template <int kW>
int launch_chain(float* d, const float* x, const CopyPlan& p,
                 const Chain& ops, bool exact, cudaStream_t st) {
  return exact ? launch_chain_k<kW, true>(d, x, p, ops, st)
               : launch_chain_k<kW, false>(d, x, p, ops, st);
}

// The f32 split of accum and chain_write must fit the two addresses and
// take whole floats.
bool f32_plan_fits(const float* d, const float* s, long long n,
                   const CopyPlan& p) {
  return plan_fits(reinterpret_cast<const unsigned char*>(d),
                   reinterpret_cast<const unsigned char*>(s), 4 * n, p) &&
         p.head % 4 == 0 && p.phase % 4 == 0;
}

int launch_copy(bool read, void* dst, const void* src, long long nbytes,
                long long head, long long nvec, long long tail, int phase,
                void* stream) {
  if (nbytes <= 0) return 0;
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const CopyPlan p{head, nvec, tail, phase};
  if (!plan_fits(d, s, nbytes, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return read ? launch_phase<true>(d, s, p, st)
              : launch_phase<false>(d, s, p, st);
}

}  // namespace

extern "C" {

// write: arena[offset : offset + n] = x; read: out = arena[offset :
// offset + n].  offset and n in elements; (head, nvec, tail, phase) is
// copy_plan of the two byte addresses and n * sizeof(element).
int repro_arena_write_f32(void* arena, const void* x, long long offset,
                          long long n, long long head, long long nvec,
                          long long tail, int phase, void* stream) {
  return launch_copy(false, static_cast<float*>(arena) + offset, x, 4 * n,
                     head, nvec, tail, phase, stream);
}

int repro_arena_write_u8(void* arena, const void* x, long long offset,
                         long long n, long long head, long long nvec,
                         long long tail, int phase, void* stream) {
  return launch_copy(false, static_cast<unsigned char*>(arena) + offset, x,
                     n, head, nvec, tail, phase, stream);
}

int repro_arena_read_f32(const void* arena, void* out, long long offset,
                         long long n, long long head, long long nvec,
                         long long tail, int phase, void* stream) {
  return launch_copy(true, out, static_cast<const float*>(arena) + offset,
                     4 * n, head, nvec, tail, phase, stream);
}

int repro_arena_read_u8(const void* arena, void* out, long long offset,
                        long long n, long long head, long long nvec,
                        long long tail, int phase, void* stream) {
  return launch_copy(true, out,
                     static_cast<const unsigned char*>(arena) + offset, n,
                     head, nvec, tail, phase, stream);
}

// accum: arena[offset : offset + n] += x; (head, nvec, tail, phase) is
// copy_plan of the arena's and x's byte addresses and 4 * n, so head,
// tail and phase are whole floats (a plan that is not is refused).
int repro_arena_accum_f32(void* arena, const void* x, long long offset,
                          long long n, long long head, long long nvec,
                          long long tail, int phase, void* stream) {
  if (n <= 0) return 0;
  float* d = static_cast<float*>(arena) + offset;
  const float* s = static_cast<const float*>(x);
  const CopyPlan p{head, nvec, tail, phase};
  if (!f32_plan_fits(d, s, n, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.phase >> 2) {
    case 0: return launch_accum<0>(d, s, p, st);
    case 1: return launch_accum<1>(d, s, p, st);
    case 2: return launch_accum<2>(d, s, p, st);
    default: return launch_accum<3>(d, s, p, st);
  }
}

// chain_write: arena[offset : offset + n] = ops(x); the split is accum's
// (copy_plan of the arena's and x's byte addresses and 4 * n, whole
// floats).  A chain longer than kMaxChain, or with an op code that is not
// one of enum ElemOp's, is refused.
int repro_arena_chain_write_f32(void* arena, const void* x, long long offset,
                                long long n, long long head, long long nvec,
                                long long tail, int phase, ChainOps ops,
                                void* stream) {
  if (n <= 0) return 0;
  float* d = static_cast<float*>(arena) + offset;
  const float* s = static_cast<const float*>(x);
  const CopyPlan p{head, nvec, tail, phase};
  if (ops.n < 0 || ops.n > kMaxChain || !f32_plan_fits(d, s, n, p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chain c{0, ops.n};
  bool exact = true;
  for (int k = 0; k < ops.n; ++k) {
    if (ops.op[k] < 0 || ops.op[k] > OP_SCALE) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    c.code |= static_cast<unsigned long long>(ops.op[k]) << (4 * k);
    exact = exact && exact_op(ops.op[k]);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p.phase >> 2) {
    case 0: return launch_chain<0>(d, s, p, c, exact, st);
    case 1: return launch_chain<1>(d, s, p, c, exact, st);
    case 2: return launch_chain<2>(d, s, p, c, exact, st);
    default: return launch_chain<3>(d, s, p, c, exact, st);
  }
}

}  // extern "C"
