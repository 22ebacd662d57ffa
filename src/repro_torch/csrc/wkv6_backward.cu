// The gradient of the RWKV-6 WKV recurrence for Hopper (sm_90a), with a
// plain C interface.
//
// It replaces no TPU kernel: `repro` differentiates the recurrence's scan
// (`jax.value_and_grad` in src/repro/launch/steps.py, through
// src/repro/kernels/rwkv6/ref.py:wkv6_ref).  It is the backward of
// csrc/wkv6.cu's forward.  Per (batch b, head h), with the N x N f32 state
// S (key i x value j), S_{t-1} the state entering step t:
//
//   forward   o_t[j] = sum_i r_t[i] S_{t-1}[i][j] + b_t v_t[j],
//             b_t = sum_i r_t[i] u[i] k_t[i],
//             S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   backward  G = dsT (zeros when null), then from the last step down:
//             dr_t[i] = sum_j S_{t-1}[i][j] do_t[j] + u[i] k_t[i] (v_t.do_t)
//             dk_t[i] = sum_j G[i][j] v_t[j] + u[i] r_t[i] (v_t.do_t)
//             dv_t[j] = sum_i G[i][j] k_t[i] + b_t do_t[j]
//             dw_t[i] = sum_j G[i][j] S_{t-1}[i][j]
//             G <- diag(w_t) G + r_t do_t^T;  ds0 = the last G
//             du[i] = sum over b and t of r_t[i] k_t[i] (v_t.do_t)
//
// Layouts are the forward's: r, k, v, w, do and the gradients (B, T, H, N)
// in bf16 or f32 (one dtype), u and du (H, N), s0, dsT and ds0 (B, H, N, N)
// f32; s0 and dsT may be null.  N is 16, 32 or 64.
//
// The trap: dr and dw need S_{t-1} while G runs backward, and S_{t-1}
// cannot be recovered backward: (S_t - k v^T) / w_t divides by a w that
// rounds to exactly 0 once exp(omega) passes ~90, and in bf16 to exactly 1
// below ~2^-9.  So the states are recomputed forward, as the forward
// kernel rounds them (__fadd_rn(__fmul_rn(w, S), __fmul_rn(k, v))), from
// f32 checkpoints: nothing is divided and nothing cancels.  csrc/wkv6.cu's
// note says why the chunked (GLA, tensor-core) form was not taken.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s f32 outside the
// tensor cores), at rwkv6-7b's training shape (B 8, T 256, H 64, N 64,
// bf16, dsT given as autograd gives it, no s0): the operations the
// gradient needs, ~14 N^2 a head and step (the state walked forward once,
// 3 N^2; the reverse step's 11 N^2: kernels/costs.py:wkv6_backward_cost),
// 7.65 GFLOP, 114 us; the bytes, r, k, v, w and do read and dr, dk, dv,
// dw written once, dsT read, 159 MB, 48 us.  In instructions it is worse:
// a walk's rounded product, product and sum are 3 instructions an element
// and the reverse step ~12 an element with its loads and merges, so the
// card's issue rate (4 warp instructions a cycle an SM) bounds it well
// above 114 us; by count this design issues ~55 K instructions a thread,
// ~490 us of the card's issue at the training shape.
//
// Its first form took 1626.46 us: one 512-thread block a (b, h) under 128
// registers, so one block an SM (3.88 waves) hid its own barriers and
// chains only; b_t and v_t.do_t were 64-term chains of one thread each;
// checkpoints every 8 steps moved 268 MB each way.  This design:
//   * a cluster of kCluster blocks a (b, h), each owning N / kCluster rows
//     of the state (rows evolve on their own: S_t[i][:] needs w_t[i],
//     k_t[i] and v_t, G[i][:] w_t[i], r_t[i] and do_t).  A thread (i, cg)
//     owns row i and the N / kRowLanes columns [cg N / kRowLanes, ..), a
//     row's kRowLanes threads on neighbouring lanes; 4 N threads a block
//     (256 at N 64: two blocks an SM, each hiding the other's barriers);
//   * checkpoints: the forward walk keeps the state every kInterval = 32
//     steps in device memory ((B, H, ceil(T / 32), N, N) f32, 67 MB each
//     way at the training shape, under the function's own 159 MB); the
//     reverse takes the intervals from the last, walks each interval's
//     states again from its checkpoint, keeping the state every kChunk = 8
//     steps in shared memory (a thread's own elements: no barrier), then
//     takes its chunks from the last: the chunk's states walked again into
//     registers (kChunk x N / kRowLanes floats), its steps from the last
//     down, G's update one FMA and one product an element;
//   * the forward walk and the intervals' walks read k and w of a thread's
//     row and v of its columns straight from device memory, 8 steps' raw
//     loads issued together (v: 16 bytes a thread at N 64, bf16), with no
//     barrier; only the reverse's chunks, which need all of r, k, v, do,
//     are staged: cp.async copies of 16 bytes into a raw ring of two
//     chunks (the next in flight while one is worked), turned into f32 in
//     shared memory once (two barriers a chunk); a ragged last chunk's
//     steps past T are staged as k = v = r = do = 0, w = 1, steps that
//     leave S and G as they are, so no step has a test;
//   * dr, dk and dw are row sums: each thread's FMA chain over its columns
//     into shared memory, added over the row's kRowLanes in order when the
//     chunk is written, off the recurrence's path;
//   * dv is a column sum over all N rows: each warp's products over its 4
//     rows merged by a reduce-scatter (xor 16, then 8: each lane keeps half
//     of what it has), the warps' partials into shared memory; at a chunk's
//     end, after a cluster barrier, each block adds its share of the
//     columns over the ranks in order (0 .. kCluster - 1) and over each
//     rank's warps in order, reading the other blocks' partials through
//     distributed shared memory: no atomics and no partials in device
//     memory, so two runs give the same bits; the partials are double
//     buffered, so one cluster barrier a chunk suffices;
//   * b_t and v_t.do_t: a warp a step, a butterfly over its lanes; each
//     block takes them over all N from the staged r, k, v, do and u;
//   * du: each (b, h)'s terms added from the last step down by one thread
//     a row, written as (B, H, N) partials, summed over b in order by a
//     second kernel.
// Its cost: the states are walked ~2.5 times (the forward once but its
// last interval, each interval again but its last chunk, each chunk again
// but its last step), against 1.9 with checkpoints every 8 steps: the
// price of keeping the checkpoints under the function's bytes.  At 128
// registers and 16 warps an SM the phases between barriers are short
// dependent chains, and the kernel issues at less than half the card's
// rate (PERF.md section 6 has its times and where they go).
// Tried and dropped, each no faster or slower on the card: the interval's
// 32 states in shared memory (128 KB a block of 16 rows: one block an SM);
// the walks staged through shared memory like the reverse's chunks (two
// barriers and a conversion a chunk of 8 steps: latency-bound); a deeper
// copy ring (past two blocks an SM); 16 lanes a row, 4 blocks a cluster,
// or three blocks an SM; a whole chunk's steps without tests by code
// duplicated for whole and ragged chunks (spills at 128 registers); the
// partials pushed into their owner's shared memory with a split cluster
// barrier; tree-ordered sums in the chunk's writes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace coop = cooperative_groups;

// must match BACKWARD_ROW_LANES, BACKWARD_CHUNK, BACKWARD_INTERVAL and
// BACKWARD_CLUSTER in kernels/rwkv6/kernel.py (the library reports them,
// and the wrapper refuses one built with others)
constexpr int kRowLanes = 8;   // threads a row of the state (neighbouring lanes)
constexpr int kChunk = 8;      // steps whose states a thread holds in registers
constexpr int kInterval = 32;  // steps between the forward walk's checkpoints
constexpr int kCluster = 2;    // blocks a (batch row, head), the rows split
constexpr int kBlocksSM = 2;   // blocks an SM the registers are bounded for
constexpr int kRing = 2;       // raw chunks: kRing - 1 in flight, one turned to f32
constexpr int kDuThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The block's shape and its dynamic shared memory, in floats: the staged
// chunk in f32 (per step k, w, v, r, do: N each), the raw ring of kRing
// chunks in T (the same layout; kRing - 1 in flight while the other is
// turned into f32), the interval's states at its chunks' starts (kSubs x
// NR x N), the warps' dv partials (two buffers of C x W x N), the rows'
// partial dr, dk, dw (3 x C x NR x kRowLanes), the chunk's bonuses and v.do
// (C each) and u (N).
template <typename T, int N>
struct Shape {
  static constexpr int C = kChunk;
  static constexpr int CL = kCluster;
  static constexpr int NR = N / CL;                 // rows a block
  static constexpr int kCols = N / kRowLanes;       // columns a thread
  static constexpr int kThreads = NR * kRowLanes;
  static constexpr int RW = 32 / kRowLanes;         // rows a warp
  static constexpr int W = kThreads / 32;           // warps a block
  static constexpr int kSubs = kInterval / kChunk;  // chunks an interval
  static constexpr int kStep = 5 * N;               // staged values a step
  static constexpr int kStage = C * kStep;
  static constexpr int kRaw = kStage;
  static constexpr int kRawSlot = kStage * (int)sizeof(T) / 4;
  static constexpr int kSub = kRaw + kRing * kRawSlot;
  static constexpr int kPart = kSub + kSubs * NR * N;
  static constexpr int kRows = kPart + 2 * C * W * N;
  static constexpr int kBon = kRows + 3 * C * NR * kRowLanes;
  static constexpr int kVdo = kBon + C;
  static constexpr int kU = kVdo + C;
  static constexpr int kFloats = kU + N;
  static constexpr int kBytes = kFloats * 4;
  static_assert(NR % RW == 0 && kThreads % 32 == 0 && kCols >= 1 &&
                    C * (N / CL) <= kThreads,
                "a block whole warps, a chunk's dv a thread an element");
  static_assert(kInterval % kChunk == 0, "an interval whole chunks");
};

// A B chunk's staging: the steps [t0, t0 + cs) of (k, w, v, r, do), 16
// bytes (kVec elements) a cp.async, copy c = tid + q NT being step c / (5 N
// / kVec), array (c / (N / kVec)) % 5, elements from (c % (N / kVec)) kVec,
// into a raw slot (step s's array a at s 5N + a N); then each thread turns
// the same copies of the landed slot into f32.
template <typename T, int N, int NT>
struct Stage {
  static constexpr int A = 5;
  static constexpr int kVec = 16 / (int)sizeof(T);
  static constexpr int kRowVecs = N / kVec;
  static constexpr int kCopies = kChunk * A * kRowVecs;
  static constexpr int kPer = (kCopies + NT - 1) / NT;

  __device__ __forceinline__ static void copy(
      T* raw, const T* k, const T* w, const T* v, const T* r, const T* d,
      long long base, long long hn, int t0, int cs, int tid) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int c = tid + q * NT, s = c / (A * kRowVecs);
      const int a = (c / kRowVecs) % A, n = (c % kRowVecs) * kVec;
      if (c < kCopies && s < cs) {
        const T* src = a == 0 ? k : a == 1 ? w : a == 2 ? v : a == 3 ? r : d;
        const unsigned dst = static_cast<unsigned>(
            __cvta_generic_to_shared(raw + s * 5 * N + a * N + n));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                     "l"(src + base + static_cast<long long>(t0 + s) * hn + n)
                     : "memory");
      }
    }
  }

  __device__ __forceinline__ static void convert(const T* raw, float* st,
                                                 int cs, int tid) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int c = tid + q * NT, s = c / (A * kRowVecs);
      const int a = (c / kRowVecs) % A, n = (c % kRowVecs) * kVec;
      if (c < kCopies && s >= cs) {    // past T: a step that changes nothing
        float4* out = reinterpret_cast<float4*>(st + s * 5 * N + a * N + n);
        const float f = a == 1 ? 1.f : 0.f;
#pragma unroll
        for (int e = 0; e < kVec / 4; ++e) out[e] = make_float4(f, f, f, f);
      } else if (c < kCopies) {
        const int off = s * 5 * N + a * N + n;
        const uint4 x = *reinterpret_cast<const uint4*>(raw + off);
        float4* out = reinterpret_cast<float4*>(st + off);
        if constexpr (sizeof(T) == 4) {
          out[0] = *reinterpret_cast<const float4*>(&x);
        } else {
          const __nv_bfloat162* h =
              reinterpret_cast<const __nv_bfloat162*>(&x);
          const float2 f0 = __bfloat1622float2(h[0]);
          const float2 f1 = __bfloat1622float2(h[1]);
          const float2 f2 = __bfloat1622float2(h[2]);
          const float2 f3 = __bfloat1622float2(h[3]);
          out[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
          out[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
        }
      }
    }
  }
};

// A thread's KC columns of a row of T, raw: KC sizeof(T) bytes in one or
// two vector loads (4 to 32 bytes), turned into f32 where used.
template <typename T, int KC>
struct RawCols {
  static constexpr int kWords = KC * (int)sizeof(T) / 4;
  static_assert(kWords >= 1 && (kWords <= 4 || kWords % 4 == 0),
                "a thread's columns are whole vector loads");
  unsigned x[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int q = 0; q < kWords / 4; ++q) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + q);
        x[4 * q] = u.x;
        x[4 * q + 1] = u.y;
        x[4 * q + 2] = u.z;
        x[4 * q + 3] = u.w;
      }
    } else if constexpr (kWords == 2) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      x[0] = u.x;
      x[1] = u.y;
    } else {
      x[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    }
  }
  __device__ __forceinline__ float operator[](int q) const {
    return to_f32(reinterpret_cast<const T*>(x)[q]);
  }
};

// The B chunks a block stages, in order: each interval I from the last,
// its chunks from the last down.  Chunk idx is interval I's chunk m of
// subs.
__device__ __forceinline__ void chunk_of(int idx, int steps, int& I, int& m,
                                         int& subs) {
  constexpr int kSubs = kInterval / kChunk;
  const int nint = (steps + kInterval - 1) / kInterval;
  const int m_last = (steps - (nint - 1) * kInterval + kChunk - 1) / kChunk;
  if (idx < m_last) {
    I = nint - 1;
    subs = m_last;
    m = m_last - 1 - idx;
  } else {
    const int rest = idx - m_last;
    I = nint - 2 - rest / kSubs;
    subs = kSubs;
    m = kSubs - 1 - rest % kSubs;
  }
}

template <typename T, int N>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(Shape<T, N>::kThreads, kBlocksSM)
    wkv6_backward_kernel(const T* __restrict__ r, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ w,
                         const T* __restrict__ u, const float* s0,
                         const T* __restrict__ dout, const float* dsT,
                         T* __restrict__ dr, T* __restrict__ dk,
                         T* __restrict__ dv, T* __restrict__ dw,
                         float* __restrict__ ds0, float* __restrict__ ckpt,
                         float* __restrict__ du_part, long long steps,
                         long long H) {
  using L = Shape<T, N>;
  constexpr int C = L::C, CL = L::CL, NR = L::NR, W = L::W;
  constexpr int NT = L::kThreads, KC = L::kCols, RW = L::RW;
  extern __shared__ __align__(16) float sm[];
  float* const st0 = sm;                              // the staged chunk
  T* const raw = reinterpret_cast<T*>(sm + L::kRaw);
  float* sub = sm + L::kSub;
  float* part = sm + L::kPart;
  float* rows = sm + L::kRows;
  float* bon = sm + L::kBon;
  float* vdo = sm + L::kVdo;
  float* us = sm + L::kU;
  using Rev = Stage<T, N, NT>;
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = tid / kRowLanes, cg = tid % kRowLanes, j0 = cg * KC;
  const int gi = rank * NR + i;                       // the row in the state
  const long long bh = blockIdx.x / CL, b = bh / H, h = bh % H;
  const long long hn = H * N;                         // elements a step
  const long long base = (b * steps * H + h) * N;     // element (b, 0, h, 0)
  const int T32 = static_cast<int>(steps);
  const long long nint = (steps + kInterval - 1) / kInterval;
  // this thread's KC state elements in (B, H, N, N), in checkpoint I, and
  // in the interval's chunk starts
  const long long sel = bh * N * N + gi * N + j0;
  auto ck = [&](long long I) { return ckpt + (bh * nint + I) * N * N +
                                      gi * N + j0; };
  float* mysub = sub + i * N + j0;
  for (int e = tid; e < N; e += NT) us[e] = to_f32(u[h * N + e]);

  // Sc[0] is the walked state (the forward walk's, an interval's again,
  // a chunk's first); Sc[s] a B chunk's S_{t0 + s - 1}
  float Sc[C][KC], G[KC];
  float (&S)[KC] = Sc[0];
#pragma unroll
  for (int q = 0; q < KC; ++q) G[q] = dsT ? dsT[sel + q] : 0.f;
  // the state entering interval I: s0 (zeros when null) or its checkpoint
  auto start = [&](long long I, float (&x)[KC]) {
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      x[q] = I == 0 ? (s0 ? s0[sel + q] : 0.f) : ck(I)[q];
    }
  };
  // one walked step of this thread's elements: st the staged step
  auto walk = [&](const float* st, const float (&from)[KC], float (&to)[KC]) {
    const float kk = st[gi], ww = st[N + gi];
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      to[q] = __fadd_rn(__fmul_rn(ww, from[q]),
                        __fmul_rn(kk, st[2 * N + j0 + q]));
    }
  };
  // S walked over the steps [t0, t1) (whole chunks) straight from device
  // memory: k and w of this thread's row and v of its columns, raw, kAhead
  // steps' loads issued together before their steps, at_chunk(t) before
  // each chunk's first step t
  auto walk_rows = [&](int t0, int t1, auto&& at_chunk) {
    using Raw = RawCols<T, KC>;
    constexpr int kAhead = Raw::kWords <= 4 ? 8 : 4;
    static_assert(kChunk % kAhead == 0, "a chunk whole batches");
    for (int t = t0; t < t1; t += kAhead) {
      T kc[kAhead], wc[kAhead];
      Raw vc[kAhead];
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const long long o = base + static_cast<long long>(t + a) * hn;
        kc[a] = k[o + gi];
        wc[a] = w[o + gi];
        vc[a].load(v + o + j0);
      }
      if (t % kChunk == 0) at_chunk(t);
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        const float kk = to_f32(kc[a]), ww = to_f32(wc[a]);
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          S[q] = __fadd_rn(__fmul_rn(ww, S[q]), __fmul_rn(kk, vc[a][q]));
        }
      }
    }
  };

  const int n_items = static_cast<int>(nint - 1) * (kInterval / kChunk) +
                      (T32 - static_cast<int>(nint - 1) * kInterval +
                       kChunk - 1) / kChunk;
  auto copy = [&](int idx) {                    // B chunk idx's copies
    T* slot = raw + (idx % kRing) * (L::kRawSlot * 4 / (int)sizeof(T));
    if (idx < n_items) {
      int I, m, subs;
      chunk_of(idx, T32, I, m, subs);
      const int t0 = I * kInterval + m * kChunk;
      Rev::copy(slot, k, w, v, r, dout, base, hn, t0,
                T32 - t0 < kChunk ? T32 - t0 : kChunk, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int idx = 0; idx < kRing - 1; ++idx) copy(idx);  // through F

  // F: the forward walk from s0, the state kept at each interval's start
  // (the first's is s0 itself)
  start(0, S);
  walk_rows(0, static_cast<int>(nint - 1) * kInterval, [&](int t) {
    if (t % kInterval == 0 && t > 0) {
#pragma unroll
      for (int q = 0; q < KC; ++q) ck(t / kInterval)[q] = S[q];
    }
  });
  if (nint > 1) {
#pragma unroll
    for (int q = 0; q < KC; ++q) ck(nint - 1)[q] = S[q];
  }

  float du_acc = 0.f;
  for (int idx = 0; idx < n_items; ++idx) {
    int I, m, subs;
    chunk_of(idx, T32, I, m, subs);
    const int t0 = I * kInterval + m * kChunk;
    const int cs = T32 - t0 < kChunk ? T32 - t0 : kChunk;
    if (m == subs - 1 && subs > 1) {
      // R: the interval's states again from its start, kept at each
      // chunk's start (this thread's own elements: no barrier)
      start(I, S);
      walk_rows(I * kInterval, I * kInterval + (subs - 1) * kChunk,
                [&](int t) {
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          mysub[(t - I * kInterval) / kChunk * NR * N + q] = S[q];
        }
      });
#pragma unroll
      for (int q = 0; q < KC; ++q) mysub[(subs - 1) * NR * N + q] = S[q];
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    __syncthreads();              // the chunk's copies landed, the last done
    Rev::convert(raw + (idx % kRing) * (L::kRawSlot * 4 / (int)sizeof(T)),
                 st0, cs, tid);
    copy(idx + kRing - 1);                            // in flight below
    __syncthreads();

    // B: the chunk's bonuses and v.do, a warp a step
    for (int s = warp; s < cs; s += W) {
      const float* st = st0 + s * L::kStep;
      float pb = 0.f, pv = 0.f;
      for (int n = lane; n < N; n += 32) {
        pb = __fadd_rn(pb, __fmul_rn(__fmul_rn(st[3 * N + n], us[n]), st[n]));
        pv = __fadd_rn(pv, __fmul_rn(st[2 * N + n], st[4 * N + n]));
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        pb = __fadd_rn(pb, __shfl_xor_sync(kFull, pb, m));
        pv = __fadd_rn(pv, __shfl_xor_sync(kFull, pv, m));
      }
      if (lane == 0) {
        bon[s] = pb;
        vdo[s] = pv;
      }
    }
    // the chunk's states S_{t-1}, walked again from its start
    if (subs == 1) {
      start(I, Sc[0]);
    } else {
#pragma unroll
      for (int q = 0; q < KC; ++q) Sc[0][q] = mysub[m * NR * N + q];
    }
    float* pt = part + (idx & 1) * C * W * N;
    // step s of the reverse, in the order of the note
    auto back = [&](int s) {
      const float* st = st0 + s * L::kStep;
      const float kk = st[gi], ww = st[N + gi], rr = st[3 * N + gi];
      float vq[KC], dq[KC];
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        vq[q] = st[2 * N + j0 + q];
        dq[q] = st[4 * N + j0 + q];
      }
      float ar = 0.f, ak = 0.f, aw = 0.f;
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        ar = __fmaf_rn(Sc[s][q], dq[q], ar);
        ak = __fmaf_rn(G[q], vq[q], ak);
        aw = __fmaf_rn(G[q], Sc[s][q], aw);
      }
      float* rw = rows + (s * NR + i) * kRowLanes + cg;
      rw[0] = ar;
      rw[C * NR * kRowLanes] = ak;
      rw[2 * C * NR * kRowLanes] = aw;
      // dv: the products over the warp's RW rows, reduce-scattered (lane
      // bits 16, 8, .. kRowLanes: each level a lane keeps half of what it
      // holds while it holds two or more, else both lanes add)
      float p[KC];
#pragma unroll
      for (int q = 0; q < KC; ++q) p[q] = __fmul_rn(G[q], kk);
      int col = j0;
      bool writes = true;
#pragma unroll
      for (int lv = 0; (16 >> lv) >= kRowLanes; ++lv) {
        const int m = 16 >> lv, held = KC >> lv;
        if (held >= 2) {
          const bool hi = lane & m;
#pragma unroll
          for (int q = 0; q < held / 2; ++q) {
            const float send = hi ? p[q] : p[q + held / 2];
            const float keep = hi ? p[q + held / 2] : p[q];
            p[q] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, m));
          }
          col += hi ? held / 2 : 0;
        } else {
          p[0] = __fadd_rn(p[0], __shfl_xor_sync(kFull, p[0], m));
          writes = writes && !(lane & m);
        }
      }
      if (writes) {
        constexpr int kHeld = KC / RW > 0 ? KC / RW : 1;
        float* pw = pt + (s * W + warp) * N + col;
#pragma unroll
        for (int q = 0; q < kHeld; ++q) pw[q] = p[q];
      }
#pragma unroll
      for (int q = 0; q < KC; ++q) {
        G[q] = __fmaf_rn(ww, G[q], __fmul_rn(rr, dq[q]));
      }
    };
    // (a ragged chunk's steps past T are staged as k = v = r = do = 0, w =
    // 1: its walk and its adjoint pass through them unchanged)
#pragma unroll
    for (int s = 1; s < C; ++s) walk(st0 + (s - 1) * L::kStep, Sc[s - 1], Sc[s]);
#pragma unroll
    for (int s = C - 1; s >= 0; --s) back(s);
    // every block's partials written (and this block's rows, bonuses)
    cluster.sync();
    // dr, dk, dw: this block's rows, a row's lanes added in order
    for (int e = tid; e < 3 * cs * NR; e += NT) {
      const int x = e / (cs * NR), s = (e / NR) % cs, ii = e % NR;
      const float* pr = rows + ((x * C + s) * NR + ii) * kRowLanes;
      float acc = pr[0];
#pragma unroll
      for (int c = 1; c < kRowLanes; ++c) acc = __fadd_rn(acc, pr[c]);
      const float* st = st0 + s * L::kStep;
      const int row = rank * NR + ii;
      const long long off = base + static_cast<long long>(t0 + s) * hn + row;
      if (x == 0) {
        store(dr + off, __fadd_rn(acc, __fmul_rn(__fmul_rn(us[row],
                                                           st[row]),
                                                 vdo[s])));
      } else if (x == 1) {
        store(dk + off, __fadd_rn(acc, __fmul_rn(__fmul_rn(us[row],
                                                           st[3 * N + row]),
                                                 vdo[s])));
      } else {
        store(dw + off, acc);
      }
    }
    if (tid < NR) {                                   // du, from the last step
      const int row = rank * NR + tid;
      for (int s = cs - 1; s >= 0; --s) {
        const float* st = st0 + s * L::kStep;
        du_acc = __fadd_rn(du_acc, __fmul_rn(__fmul_rn(st[3 * N + row],
                                                       st[row]), vdo[s]));
      }
    }
    // dv: (step sv, column jv), one of this block's N / CL columns a
    // thread, the ranks' warps added in order
    const int sv = tid / (N / CL), jv = rank * (N / CL) + tid % (N / CL);
    if (sv < cs) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < CL; ++q) {
        const float* pr = cluster.map_shared_rank(pt, q) + sv * W * N + jv;
#pragma unroll
        for (int x = 0; x < W; ++x) {
          acc = q == 0 && x == 0 ? pr[0] : __fadd_rn(acc, pr[x * N]);
        }
      }
      store(dv + base + static_cast<long long>(t0 + sv) * hn + jv,
            __fadd_rn(acc, __fmul_rn(bon[sv], st0[sv * L::kStep + 4 * N + jv])));
    }
  }
#pragma unroll
  for (int q = 0; q < KC; ++q) ds0[sel + q] = G[q];
  if (tid < NR) du_part[bh * N + rank * NR + tid] = du_acc;
  cluster.sync();            // no block leaves while another reads its part
}

// du[h][n] = sum over b of du_part[b][h][n], in order from b = 0
template <typename T>
__global__ void __launch_bounds__(kDuThreads)
    wkv6_du_kernel(const float* __restrict__ du_part, T* __restrict__ du,
                   long long B, long long hn) {
  const long long e = (long long)blockIdx.x * kDuThreads + threadIdx.x;
  if (e >= hn) return;
  float acc = du_part[e];
  for (long long b = 1; b < B; ++b) acc = __fadd_rn(acc, du_part[b * hn + e]);
  store(du + e, acc);
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, const void* dout, const void* dsT,
           void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
           void* ckpt, void* du_part, long long B, long long steps,
           long long H, cudaStream_t stream) {
  using L = Shape<T, N>;
  static_assert(L::kBytes <= 232448, "a block's shared memory");
  // the 16-byte copies need 16-byte aligned rows
  for (const void* p : {r, k, v, w, dout}) {
    if (reinterpret_cast<unsigned long long>(p) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (L::kBytes > 48 * 1024) {
    static bool raised = false;      // once per instantiation
    if (!raised) {
      const cudaError_t e = cudaFuncSetAttribute(
          wkv6_backward_kernel<T, N>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      raised = true;
    }
  }
  wkv6_backward_kernel<T, N>
      <<<static_cast<unsigned>(B * H * L::CL), L::kThreads, L::kBytes,
         stream>>>(
          static_cast<const T*>(r), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(w),
          static_cast<const T*>(u), static_cast<const float*>(s0),
          static_cast<const T*>(dout), static_cast<const float*>(dsT),
          static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
          static_cast<T*>(dw), static_cast<float*>(ds0),
          static_cast<float*>(ckpt), static_cast<float*>(du_part), steps, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long hn = H * N;
  wkv6_du_kernel<T>
      <<<static_cast<unsigned>((hn + kDuThreads - 1) / kDuThreads),
         kDuThreads, 0, stream>>>(static_cast<const float*>(du_part),
                                  static_cast<T*>(du), B, hn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* s0, const void* dout, const void* dsT,
             void* dr, void* dk, void* dv, void* dw, void* du, void* ds0,
             void* ckpt, void* du_part, long long B, long long steps,
             long long H, long long N, cudaStream_t stream) {
  if (N == 16)
    return launch<T, 16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du,
                         ds0, ckpt, du_part, B, steps, H, stream);
  if (N == 32)
    return launch<T, 32>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du,
                         ds0, ckpt, du_part, B, steps, H, stream);
  if (N == 64)
    return launch<T, 64>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du,
                         ds0, ckpt, du_part, B, steps, H, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The constants this library was built with: kRowLanes, kChunk, kInterval
// and kCluster.  The wrapper refuses a library whose constants differ from
// its own.
void repro_wkv6_backward_constants(int* out) {
  out[0] = kRowLanes;
  out[1] = kChunk;
  out[2] = kInterval;
  out[3] = kCluster;
}

// Each entry launches the backward kernel and the du kernel on `stream` and
// returns cudaGetLastError() (0 when both launches were accepted).  s0 and
// dsT may be null (zeros); ds0 is written either way.  ckpt is scratch of
// (B, H, ceil(T / kInterval), N, N) f32 and du_part of (B, H, N) f32.  The
// wrapper has checked shapes, dtypes, contiguity, T >= 1 and N.
int repro_wkv6_backward_bf16(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             const void* dout, const void* dsT, void* dr,
                             void* dk, void* dv, void* dw, void* du,
                             void* ds0, void* ckpt, void* du_part,
                             long long B, long long T, long long H,
                             long long N, void* stream) {
  return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv,
                                 dw, du, ds0, ckpt, du_part, B, T, H, N,
                                 static_cast<cudaStream_t>(stream));
}

int repro_wkv6_backward_f32(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            const void* dout, const void* dsT, void* dr,
                            void* dk, void* dv, void* dw, void* du, void* ds0,
                            void* ckpt, void* du_part, long long B,
                            long long T, long long H, long long N,
                            void* stream) {
  return dispatch<float>(r, k, v, w, u, s0, dout, dsT, dr, dk, dv, dw, du,
                         ds0, ckpt, du_part, B, T, H, N,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
