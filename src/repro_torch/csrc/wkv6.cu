// The RWKV-6 WKV recurrence for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel `wkv6_pallas` / `_wkv6_kernel`
// (src/repro/kernels/rwkv6/kernel.py).  Per (batch b, head h), with an N x N
// f32 state S (key i x value j), data-dependent decay w_t and bonus u:
//
//   o_t[j] = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// Layouts are the public function's: r, k, v, w and o (B, T, H, N), u (H, N),
// in bf16 or f32 (one dtype for all); the initial state s0 (may be null:
// zeros) and the final state sT (B, H, N, N) f32.  sT may be s0 itself: a
// block reads its own columns of s0 before the loop and writes them after.
// N is 16, 32 or 64 (a template argument; the wrapper refuses others).  Any
// T >= 1: the last chunk may be ragged.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the
// tensor cores):
//   * prefill (rwkv6-7b: B 1, H 64, N 64, T 1024, bf16): operations.  The
//     table's bound counts 5 N^2 flops per head and step (an FMA as two):
//     1.34 GFLOP, 20.3 us.  Issued instructions set a higher floor: the
//     state update must stay three rounded operations (below), and the
//     output's product and sum one FMA, so 4 N^2 instructions per head and
//     step, 1.07 G at rwkv6-7b's prefill: ~36 us at 132 SMs x 128 lanes x
//     ~1.75 GHz (32 us at the 1.98 GHz boost clock).  The bytes (r, k, v,
//     w read once, o written once, the state read and written once) are
//     44 MB, 13 us.
//   * decode (T 1): bytes, the state read and written once: 2.1 MB, 0.63 us.
//
// Design.  Column j of S needs only w_t, k_t, r_t (all N) and v_t[j], so
//   * columns go across blocks: the grid is (b, h, tile of JT = kTileCols
//     columns), B * H * N / JT blocks (256 at rwkv6-7b, about two an SM;
//     decode spreads the state's bytes over as many);
//   * rows go across threads: each column's N rows are split over R =
//     kRowSplit lanes of one warp (N / R contiguous rows each, in
//     registers), lane = g * (32 / R) + c for row group g and column c of
//     the warp, so every thread has N / R independent state updates a
//     step;
//   * time is staged by chunks of C = kChunk steps: r, k, w (all N) and v
//     (the tile's JT columns) of the next chunk arrive in shared memory by
//     16-byte cp.async (two buffers) while this chunk is computed, which
//     reads it as it was staged (a bf16 row is widened in registers);
//   * a step's bonus b_t = sum_i r_i u_i k_i is taken once, by
//     kBonusSplit lanes, before the chunk's steps;
//   * each thread leaves its partial output sums of the chunk in shared
//     memory; after the next barrier they are merged, b_t v_t[j] added,
//     and the chunk's outputs written by 16-byte stores.
// Two barriers a chunk, none a step, and no branch between the steps of a
// full chunk.  A launch of one step (decode) skips the staging and the
// shared memory: one round trip to memory, with no barrier (coalescing
// the state's loads through shared memory, at the cost of two barriers,
// was slower: tools/wkv6_probe.py).
//
// Rounding.  The state update is __fadd_rn(__fmul_rn(w, S), __fmul_rn(k,
// v)), no FMA contraction, so the state is bit-equal to a plain version
// that spells it w * S + k * v in f32 (`wkv6_ref`).  The output of a
// column is each thread's rows summed in order by FMA, the R partial sums
// merged pairwise at distance 1, 2, ..., R / 2 (as a butterfly over the
// row groups would), plus b_t v_t[j]; b_t is kBonusSplit runs of N /
// kBonusSplit consecutive products (r u) k, each summed in order, merged
// the same way.  Neither order depends on a step's place in its chunk, on
// T or on the tile, so a run split in two with the state threaded gives
// the whole run's outputs bit for bit.  `wkv6_tiled_torch`
// (kernels/rwkv6/ref.py) repeats this decomposition in plain PyTorch.
//
// Rejected: the chunked linear-attention (GLA) form with tensor-core
// products.  Its exp(+-cumsum log w) factors overflow f32 past ~88 nats at
// RWKV-6's decays (src/repro/kernels/rwkv6/ops.py), and it would change the
// state's rounding, so the state would no longer be bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// must match TILE_COLS, ROW_SPLIT, CHUNK and BONUS_SPLIT in
// kernels/rwkv6/kernel.py (the library reports them, and the wrapper
// refuses one built with others)
constexpr int kTileCols = 16;  // JT: columns of S a block owns (at most N)
constexpr int kRowSplit = 8;   // R: lanes a column's N rows are split over
constexpr int kChunk = 16;     // C: steps staged in shared memory at a time
constexpr int kBonusSplit = 8; // lanes a step's bonus is split over
// columns a thread owns (a divisor of JT): the arithmetic of a column does
// not depend on it, so the plain version does not take it; kept for
// tools/wkv6_probe.py's variants
constexpr int kColsThread = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x[0:M] = p[0:M] from shared memory, as f32, in the widest loads p's
// alignment (M elements from a multiple of M) allows
template <int M>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = f.x;
      x[4 * q + 1] = f.y;
      x[4 * q + 2] = f.z;
      x[4 * q + 3] = f.w;
    }
  } else if constexpr (M % 2 == 0) {
#pragma unroll
    for (int q = 0; q < M / 2; ++q) {
      const float2 f = reinterpret_cast<const float2*>(p)[q];
      x[2 * q] = f.x;
      x[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < M; ++q) x[q] = p[q];
  }
}

// bf16 is the top half of an f32: the low and the high bf16 of a word
__device__ __forceinline__ float bf16_lo(unsigned int w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int M>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p,
                                          float (&x)[M]) {
  if constexpr (M % 8 == 0) {
#pragma unroll
    for (int q = 0; q < M / 8; ++q) {
      const uint4 f = reinterpret_cast<const uint4*>(p)[q];
      const unsigned int w[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[8 * q + 2 * e] = bf16_lo(w[e]);
        x[8 * q + 2 * e + 1] = bf16_hi(w[e]);
      }
    }
  } else if constexpr (M % 2 == 0) {
#pragma unroll
    for (int q = 0; q < M / 2; ++q) {
      const unsigned int w = reinterpret_cast<const unsigned int*>(p)[q];
      x[2 * q] = bf16_lo(w);
      x[2 * q + 1] = bf16_hi(w);
    }
  } else {
#pragma unroll
    for (int q = 0; q < M; ++q) x[q] = __bfloat162float(p[q]);
  }
}

constexpr int round16(int bytes) { return (bytes + 15) / 16 * 16; }

// The block's shape and its dynamic shared memory, in this order: two
// staged chunks in T (per step r, k, w: N each, v: JT), the partial
// output sums of a chunk (C x JT x R f32), the bonuses of two chunks
// (2 x C), a chunk's outputs in T (C x JT), u (N) and the state tile
// (N x (JT + 1)).  A thread owns RT = N / R rows of CJ = kColsThread
// columns; a warp 32 / R groups of CJ columns.
template <typename T, int N>
struct Layout {
  static constexpr int JT = N < kTileCols ? N : kTileCols;
  static constexpr int R = kRowSplit;
  static constexpr int C = kChunk;
  static constexpr int CJ = kColsThread;
  static constexpr int BS = kBonusSplit;
  static constexpr int RT = N / R;         // rows a thread
  static constexpr int CPW = 32 / R;       // column groups a warp
  static constexpr int kThreads = JT / CJ * R;
  static constexpr int kTiles = N / JT;
  static constexpr int kRawRow = 3 * N + JT;       // staged elements a step
  static constexpr int kRawBuf = C * kRawRow;      // elements a staged chunk
  static constexpr int kEpv = 16 / sizeof(T);      // elements a 16-byte vector
  static constexpr int kPitch = JT + 1;            // state tile row, floats
  static constexpr int kRaw = 0;
  static constexpr int kPart = round16(kRaw + 2 * kRawBuf * sizeof(T));
  static constexpr int kBon = kPart + C * JT * R * 4;
  static constexpr int kOut = round16(kBon + 2 * C * 4);
  static constexpr int kU = round16(kOut + C * JT * sizeof(T));
  static constexpr int kSt = round16(kU + N * 4);
  static constexpr int kBytes = round16(kSt + N * kPitch * 4);

  static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0,
                "kRowSplit must be a power of two up to 32");
  static_assert(N % R == 0 && N % JT == 0 && JT % CJ == 0,
                "N must split into R and JT, JT into CJ");
  static_assert(kThreads % 32 == 0 && kThreads % BS == 0,
                "a block must be whole warps and bonus groups");
  static_assert(BS >= 1 && BS <= 32 && (BS & (BS - 1)) == 0 && N % BS == 0,
                "kBonusSplit must be a power of two that divides N");
  static_assert((N * sizeof(T)) % 16 == 0 && (JT * sizeof(T)) % 16 == 0,
                "rows of r, k, w and the tile of v must be 16-byte vectors");
};

// One block owns columns [j0, j0 + JT) of the state of one (b, h) for all
// steps.  kVec: r, k, v, w and o are 16-byte aligned (every tensor the
// wrapper allocates or the model passes), so chunks are staged by cp.async
// and the outputs stored 16 bytes at a time; else element by element.
//
// Chunk c, between its two barriers: the outputs of chunk c - 1 (partial
// sums merged, plus bonus times v) into obuf, and the bonuses of chunk c;
// after the second: chunk c + 1's loads issued, chunk c - 1's outputs
// stored, chunk c's steps.  A full chunk's steps are unrolled with no
// branch between them; the last, ragged chunk's are a loop.
template <typename T, int N, bool kVec>
__global__ void __launch_bounds__(Layout<T, N>::kThreads, 2)
    wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const T* __restrict__ u, const float* s0, T* __restrict__ o,
                float* sT, long long steps, long long H) {
  using L = Layout<T, N>;
  constexpr int JT = L::JT, R = L::R, C = L::C, RT = L::RT, CPW = L::CPW;
  constexpr int CJ = L::CJ, BS = L::BS, kThreads = L::kThreads;
  constexpr int E = kVec ? L::kEpv : 1;        // elements a global move
  constexpr int VR = N / E, VS = (3 * N + JT) / E, VO = JT / E;
  constexpr int kStage = (C * VS + kThreads - 1) / kThreads;
  constexpr int kStore = (C * VO + kThreads - 1) / kThreads;
  constexpr int kFinal = (C * JT + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem + L::kRaw);
  float* part = reinterpret_cast<float*>(smem + L::kPart);
  float* bon = reinterpret_cast<float*>(smem + L::kBon);
  T* obuf = reinterpret_cast<T*>(smem + L::kOut);
  float* us = reinterpret_cast<float*>(smem + L::kU);
  float* st = reinterpret_cast<float*>(smem + L::kSt);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / CPW;                    // row group: rows g*RT + m
  // first of this thread's CJ columns within the tile
  const int jl = (warp * CPW + lane % CPW) * CJ;
  const int tile = static_cast<int>(blockIdx.x % L::kTiles);
  const int bh = static_cast<int>(blockIdx.x / L::kTiles);
  const long long b = bh / static_cast<int>(H), h = bh % static_cast<int>(H);
  const int j0 = tile * JT;
  const long long hn = H * N;                  // elements a step
  const long long base = (b * steps * H + h) * N;   // element (b, 0, h, 0)
  auto steps_of = [&](long long t0) {
    return static_cast<int>(steps - t0 < C ? steps - t0 : C);
  };
  const long long sbase = static_cast<long long>(bh) * N * N + j0;

  // One step (decode), with no shared memory and no barrier: each thread
  // loads its rows of r, k, w and u and its state straight from memory,
  // and the lanes of a column merge the bonus's and the output's partial
  // sums by shuffles, pairs at distance 1, 2, ..., R / 2 in row groups as
  // the chunked path merges them in shared memory (with R == kBonusSplit
  // the bonus's runs are the row groups), so both paths give the same
  // bits.
  if constexpr (kVec && R == BS) {
    if (steps == 1) {
      float rv[RT], kv[RT], wv[RT], uv[RT], vj[CJ], S1[CJ][RT];
      load_rows<RT>(r + base + g * RT, rv);
      load_rows<RT>(k + base + g * RT, kv);
      load_rows<RT>(w + base + g * RT, wv);
#pragma unroll
      for (int m = 0; m < RT; ++m) uv[m] = to_f32(u[h * N + g * RT + m]);
#pragma unroll
      for (int q = 0; q < CJ; ++q) {
        vj[q] = to_f32(v[base + j0 + jl + q]);
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          S1[q][m] = s0 ? s0[sbase + static_cast<long long>(g * RT + m) * N +
                             jl + q]
                        : 0.f;
        }
      }
      float p = 0.f;
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        p = __fadd_rn(p, __fmul_rn(__fmul_rn(rv[m], uv[m]), kv[m]));
      }
#pragma unroll
      for (int m = CPW; m < 32; m <<= 1) {
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, m));
      }
#pragma unroll
      for (int q = 0; q < CJ; ++q) {
        float a = 0.f;
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          a = __fmaf_rn(rv[m], S1[q][m], a);
          S1[q][m] = __fadd_rn(__fmul_rn(wv[m], S1[q][m]),
                               __fmul_rn(kv[m], vj[q]));
        }
#pragma unroll
        for (int m = CPW; m < 32; m <<= 1) {
          a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, m));
        }
        if (g == 0) {
          store(o + base + j0 + jl + q, __fadd_rn(a, __fmul_rn(p, vj[q])));
        }
#pragma unroll
        for (int m = 0; m < RT; ++m) {
          sT[sbase + static_cast<long long>(g * RT + m) * N + jl + q] =
              S1[q][m];
        }
      }
      return;
    }
  }

  // This thread's moves of a chunk's staging: step, shared offset and the
  // source at t0 = 0.
  int stage_s[kStage], stage_d[kStage];
  const T* stage_src[kStage];
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int q = tid + i * kThreads, s = q / VS, e = q % VS;
    const T* arr = e < 3 * VR ? (e / VR == 0 ? r : e / VR == 1 ? k : w) : v;
    const int off = e < 3 * VR ? (e % VR) * E : j0 + (e - 3 * VR) * E;
    stage_s[i] = q < C * VS ? s : C;           // C: no move
    stage_d[i] = s * L::kRawRow + e * E;
    stage_src[i] = arr + base + s * hn + off;
  }
  // chunk [t0, t0 + cs) into staging buffer buf
  auto stage = [&](long long t0, int buf) {
    const int cs = steps_of(t0);
    T* dst = raw + buf * L::kRawBuf;
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      if (stage_s[i] < cs) {
        if constexpr (kVec) {
          cp_async16(dst + stage_d[i], stage_src[i] + t0 * hn);
        } else {
          dst[stage_d[i]] = stage_src[i][t0 * hn];
        }
      }
    }
    if constexpr (kVec) cp_async_commit();
  };
  // the outputs of chunk [t0, t0 + cs), gathered in obuf
  auto store_out = [&](long long t0, int cs) {
#pragma unroll
    for (int i = 0; i < kStore; ++i) {
      const int q = tid + i * kThreads, s = q / VO, e = (q % VO) * E;
      if (q < C * VO && s < cs) {
        T* dst = o + base + (t0 + s) * hn + j0 + e;
        if constexpr (kVec) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(obuf + s * JT + e);
        } else {
          *dst = obuf[s * JT + e];
        }
      }
    }
  };
  // The bonus of each step of staged chunk buf into bon[buf]: BS lanes a
  // step, each the products (r u) k of N / BS consecutive rows in order,
  // merged by a butterfly (1, 2, ..., BS / 2).
  auto bonus = [&](int buf, int cs) {
    constexpr int kPer = N / BS;
    const int part_of = lane % BS;
    for (int s1 = 0; s1 < C; s1 += kThreads / BS) {   // uniform trips
      const int s = s1 + tid / BS;
      float p = 0.f;
      if (s < cs) {
        const T* row = raw + buf * L::kRawBuf + s * L::kRawRow;
        float rv[kPer], kv[kPer];
        load_rows<kPer>(row + part_of * kPer, rv);
        load_rows<kPer>(row + N + part_of * kPer, kv);
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          p = __fadd_rn(p, __fmul_rn(__fmul_rn(rv[m], us[part_of * kPer + m]),
                                     kv[m]));
        }
      }
#pragma unroll
      for (int m = 1; m < BS; m <<= 1) {
        p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, m));
      }
      if (part_of == 0 && s < cs) bon[buf * C + s] = p;
    }
  };
  // The outputs of staged chunk buf: each (step, column)'s R partial sums
  // merged as the butterfly over the row groups does (pairs at distance
  // 1, 2, ..., R / 2), plus bonus times v.
  auto finalize = [&](int buf, int cs) {
#pragma unroll
    for (int i = 0; i < kFinal; ++i) {
      const int q = tid + i * kThreads, s = q / JT, col = q % JT;
      if (q < C * JT && s < cs) {
        float pr[R];
        load_rows<R>(part + (s * JT + col) * R, pr);
#pragma unroll
        for (int m = 1; m < R; m <<= 1) {
#pragma unroll
          for (int i2 = 0; i2 < R; i2 += 2 * m) {
            pr[i2] = __fadd_rn(pr[i2], pr[i2 + m]);
          }
        }
        const float vq =
            to_f32(raw[buf * L::kRawBuf + s * L::kRawRow + 3 * N + col]);
        store(obuf + s * JT + col,
              __fadd_rn(pr[0], __fmul_rn(bon[buf * C + s], vq)));
      }
    }
  };
  // the chunk's steps on this thread's rows of its CJ columns; each
  // step's partial output sums into part
  float S[CJ][RT];                       // S[q][m] = state[g*RT + m][jl + q]
  auto step = [&](const T* row, int s) {
    float rv[RT], kv[RT], wv[RT], vj[CJ];
    load_rows<RT>(row + g * RT, rv);
    load_rows<RT>(row + N + g * RT, kv);
    load_rows<RT>(row + 2 * N + g * RT, wv);
#pragma unroll
    for (int q = 0; q < CJ; ++q) vj[q] = to_f32(row[3 * N + jl + q]);
#pragma unroll
    for (int q = 0; q < CJ; ++q) {
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        a = __fmaf_rn(rv[m], S[q][m], a);
        S[q][m] = __fadd_rn(__fmul_rn(wv[m], S[q][m]),
                            __fmul_rn(kv[m], vj[q]));
      }
      part[(s * JT + jl + q) * R + g] = a;
    }
  };

  // The first chunk's loads, u's and the state tile's all go out before
  // any of them is waited for: one round trip to memory.
  stage(0, 0);
  constexpr int kU = (N + kThreads - 1) / kThreads;
  constexpr int kS = N * JT / kThreads;        // state floats a thread
  static_assert((N * JT) % kThreads == 0, "the tile splits over the block");
  float uv[kU], sv[kS];
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    const int e = tid + i * kThreads;
    uv[i] = e < N ? to_f32(u[h * N + e]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int e = tid + i * kThreads;
    sv[i] = s0 ? s0[sbase + static_cast<long long>(e / JT) * N + e % JT]
               : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    if (tid + i * kThreads < N) us[tid + i * kThreads] = uv[i];
  }
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int e = tid + i * kThreads;
    st[(e / JT) * L::kPitch + e % JT] = sv[i];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < CJ; ++q) {
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      S[q][m] = st[(g * RT + m) * L::kPitch + jl + q];
    }
  }

  const long long nchunks = (steps + C - 1) / C;
  for (long long c = 0; c < nchunks; ++c) {
    const long long t0 = c * C;
    const int cs = steps_of(t0), buf = static_cast<int>(c & 1);
    if constexpr (kVec) cp_async_wait_all();
    // chunk c staged; chunk c - 1's steps done
    __syncthreads();
    if (c > 0) finalize(buf ^ 1, C);
    bonus(buf, cs);
    // chunk c - 1's outputs gathered and its staging buffer free
    __syncthreads();
    if (c + 1 < nchunks) stage(t0 + C, buf ^ 1);
    if (c > 0) store_out(t0 - C, C);
    const T* rows = raw + buf * L::kRawBuf;
    if (cs == C) {
#pragma unroll
      for (int s = 0; s < C; ++s) step(rows + s * L::kRawRow, s);
    } else {
#pragma unroll 1
      for (int s = 0; s < cs; ++s) step(rows + s * L::kRawRow, s);
    }
  }
#pragma unroll
  for (int q = 0; q < CJ; ++q) {
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      st[(g * RT + m) * L::kPitch + jl + q] = S[q][m];
    }
  }
  __syncthreads();
  const long long t0 = (nchunks - 1) * C;
  finalize(static_cast<int>((nchunks - 1) & 1), steps_of(t0));
  __syncthreads();
  store_out(t0, steps_of(t0));
  for (int e = tid; e < N * JT; e += kThreads) {
    const int i = e / JT, jj = e % JT;
    sT[sbase + static_cast<long long>(i) * N + jj] = st[i * L::kPitch + jj];
  }
}

template <typename T, int N, bool kVec>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const float* s0, void* o, float* sT, long long B,
           long long steps, long long H, cudaStream_t stream) {
  using L = Layout<T, N>;
  if (L::kBytes > 48 * 1024) {
    static bool raised = false;      // once per instantiation
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          wkv6_kernel<T, N, kVec>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  wkv6_kernel<T, N, kVec>
      <<<static_cast<unsigned>(B * H * L::kTiles), L::kThreads, L::kBytes,
         stream>>>(static_cast<const T*>(r), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(w),
                   static_cast<const T*>(u), s0, static_cast<T*>(o), sT,
                   steps, H);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T, int N>
int launch_n(const void* r, const void* k, const void* v, const void* w,
             const void* u, const float* s0, void* o, float* sT, long long B,
             long long steps, long long H, cudaStream_t stream) {
  if (aligned16(r) && aligned16(k) && aligned16(v) && aligned16(w) &&
      aligned16(o)) {
    return launch<T, N, true>(r, k, v, w, u, s0, o, sT, B, steps, H, stream);
  }
  return launch<T, N, false>(r, k, v, w, u, s0, o, sT, B, steps, H, stream);
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, void* o, void* sT, long long B,
             long long steps, long long H, long long N, cudaStream_t stream) {
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  if (N == 16)
    return launch_n<T, 16>(r, k, v, w, u, s0f, o, sTf, B, steps, H, stream);
  if (N == 32)
    return launch_n<T, 32>(r, k, v, w, u, s0f, o, sTf, B, steps, H, stream);
  if (N == 64)
    return launch_n<T, 64>(r, k, v, w, u, s0f, o, sTf, B, steps, H, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The decomposition this library was built with: JT, R, C and the bonus
// split.  The wrapper
// refuses a library whose constants differ from its own.
void repro_wkv6_constants(int* out) {
  out[0] = kTileCols;
  out[1] = kRowSplit;
  out[2] = kChunk;
  out[3] = kBonusSplit;
}

// Each entry launches on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  s0 may be null (a zero initial state); sT may equal
// s0.  The wrapper has checked shapes, dtypes, contiguity, T >= 1 and N.
int repro_wkv6_bf16(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* s0, void* o,
                    void* sT, long long B, long long T, long long H,
                    long long N, void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, o, sT, B, T, H, N,
                                 static_cast<cudaStream_t>(stream));
}

int repro_wkv6_f32(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* o,
                   void* sT, long long B, long long T, long long H,
                   long long N, void* stream) {
  return dispatch<float>(r, k, v, w, u, s0, o, sT, B, T, H, N,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
