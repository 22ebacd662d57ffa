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
// over 3.35 TB/s -- 0.36 us for the largest tensor of the DARTS cell
// (150,528 f32 elements, read once and written once).  At the arena sizes
// of the paper's edge networks (0.7-3 MB) that is below the ~2-4 us a
// launch costs, so launch latency and the host loop that issues the
// launches are the real bound.  The design does the one thing that helps
// at the kernel: it touches only the n elements of the slice (the Pallas
// kernels copy the whole arena through, which exists only for their
// interpret mode), and chain_write applies a whole alias chain in registers
// so a fused chain costs one launch.  Vector loads, TMA and CUDA-graph
// capture of the whole program are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
// enough blocks to fill 132 SMs several times over; the grid-stride loop
// covers any longer slice
constexpr long long kMaxBlocks = 132LL * 8;

constexpr int kMaxChain = 16;  // MAX_CHAIN in kernels/arena/elemwise.py

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

// The chain travels by value in the kernel's parameters: no device copy of
// the op list, no extra launch.
struct ChainOps {
  int n;
  int op[kMaxChain];
};

namespace {

unsigned int grid_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// Replaces arena_write_pallas / _write_kernel (src/repro/kernels/arena/
// kernel.py).  Bound: 2*n*sizeof(T) bytes over 3.35 TB/s, under the launch
// latency at these sizes.  One coalesced grid-stride copy of the slice.
template <typename T>
__global__ void write_kernel(T* arena, const T* __restrict__ x,
                             long long offset, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    arena[offset + i] = x[i];
  }
}

// Replaces arena_read_pallas / _read_kernel.  Bound as write.  The output
// is a fresh buffer the wrapper allocates, never a view of the arena.
template <typename T>
__global__ void read_kernel(const T* arena, T* __restrict__ out,
                            long long offset, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    out[i] = arena[offset + i];
  }
}

// Replaces arena_accum_pallas / _accum_kernel: the rewritten partial-conv
// step.  Bound: 3*n*4 bytes (slice read, x read, slice written).  The add is
// __fadd_rn, bit-equal to torch's eager add.
__global__ void accum_kernel(float* arena, const float* __restrict__ x,
                             long long offset, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    arena[offset + i] = __fadd_rn(arena[offset + i], x[i]);
  }
}

// The unary ops of ELEMWISE_FNS.  relu, relu6, bn, bias_add and scale use
// the same arithmetic as torch's eager CUDA kernels, with _rn intrinsics so
// no FMA contraction separates them: bit-equal.  The transcendentals follow
// torch's formulas with expf/tanhf: allclose.
__device__ __forceinline__ float apply_op(int op, float v) {
  switch (op) {
    case OP_RELU:
      return isnan(v) ? v : fmaxf(v, 0.0f);
    case OP_RELU6:
      return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 6.0f);
    case OP_BN:
      return __fsub_rn(__fmul_rn(v, 1.05f), 0.02f);
    case OP_SIGMOID:
      return 1.0f / (1.0f + expf(-v));
    case OP_TANH:
      return tanhf(v);
    case OP_GELU: {
      // tanh form, as jax.nn.gelu's default and F.gelu(approximate="tanh")
      const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
      const float kKappa = 0.044715f;
      const float inner = kBeta * (v + kKappa * (v * v * v));
      return 0.5f * v * (1.0f + tanhf(inner));
    }
    case OP_SILU:
      return v / (1.0f + expf(-v));
    case OP_BIAS_ADD:
      return __fadd_rn(v, 0.05f);
    case OP_SCALE:
      return __fmul_rn(v, 0.9f);
    default:  // identity, dropout (inference), cast_inplace
      return v;
  }
}

// Replaces arena_chain_write_pallas / _chain_write_kernel: a whole in-place
// alias chain in one launch.  Bound: 2*n*4 bytes; the chain's flops (a few
// dozen per element at most) are far below the card's 67 TFLOP/s f32 rate.
// The running value stays in a register from the first op to the store.
__global__ void chain_write_kernel(float* arena, const float* __restrict__ x,
                                   long long offset, long long n,
                                   ChainOps ops) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float v = x[i];
    for (int k = 0; k < ops.n; ++k) {
      v = apply_op(ops.op[k], v);
    }
    arena[offset + i] = v;
  }
}

template <typename T>
int launch_write(void* arena, const void* x, long long offset, long long n,
                 void* stream) {
  if (n <= 0) return 0;
  write_kernel<T><<<grid_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(arena), static_cast<const T*>(x), offset, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_read(const void* arena, void* out, long long offset, long long n,
                void* stream) {
  if (n <= 0) return 0;
  read_kernel<T><<<grid_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(arena), static_cast<T*>(out), offset, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int repro_arena_write_f32(void* arena, const void* x, long long offset,
                          long long n, void* stream) {
  return launch_write<float>(arena, x, offset, n, stream);
}

int repro_arena_write_u8(void* arena, const void* x, long long offset,
                         long long n, void* stream) {
  return launch_write<unsigned char>(arena, x, offset, n, stream);
}

int repro_arena_read_f32(const void* arena, void* out, long long offset,
                         long long n, void* stream) {
  return launch_read<float>(arena, out, offset, n, stream);
}

int repro_arena_read_u8(const void* arena, void* out, long long offset,
                        long long n, void* stream) {
  return launch_read<unsigned char>(arena, out, offset, n, stream);
}

int repro_arena_accum_f32(void* arena, const void* x, long long offset,
                          long long n, void* stream) {
  if (n <= 0) return 0;
  accum_kernel<<<grid_for(n), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(arena), static_cast<const float*>(x), offset, n);
  return static_cast<int>(cudaGetLastError());
}

int repro_arena_chain_write_f32(void* arena, const void* x, long long offset,
                                long long n, ChainOps ops, void* stream) {
  if (n <= 0) return 0;
  if (ops.n < 0 || ops.n > kMaxChain) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chain_write_kernel<<<grid_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(arena), static_cast<const float*>(x), offset, n,
      ops);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
