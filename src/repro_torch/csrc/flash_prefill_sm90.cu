// Tensor-core prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces, for bf16 calls with Sq * G > 16 and (D, Dv) in {(64, 64),
// (128, 128), (192, 128), (256, 256)}, the Pallas TPU kernel
// `flash_attention_pallas` / `_fa_kernel`
// (src/repro/kernels/flash_attention/kernel.py), and at (192, 128), which
// the Pallas kernel does not take (it gives v's blocks the width D),
// `repro`'s `_flash_xla` (ops.py): GQA attention with an online softmax,
// causal, sliding `window`, `q_start` / `kv_len`, m / l / acc in f32, fully
// masked key tiles skipped with `_fa_kernel`'s block test, a row with no
// live key gives 0, the result is acc / max(l, 1e-30).  Layouts are the
// public function's: q (B,Sq,H,D), k (B,Skv,KV,D), v (B,Skv,KV,Dv), out
// (B,Sq,H,Dv), all bf16.  The f32 calls and the (16, 16) pair stay on
// flash_attention.cu.
//
// What bounds it on an H100 SXM: operations.  A causal prefill of P tokens
// does 2 * H * (D + Dv) flops per live (query, key) pair: 4.3 GFLOP per
// llama3.2-1b layer at P = 1024 (4.3 us at 989 TFLOP/s bf16), 32 GFLOP per
// recurrentgemma-2b layer at P = 2560 with its 2048-key window (32.6 us),
// 43 GFLOP per deepseek-v3-671b MLA layer at P = 1024 (128 heads of
// (192, 128): 43.5 us).  Only the tensor cores reach that rate, and on
// Hopper only through `wgmma`.
//
// Design.  One block is one warpgroup (128 threads) and owns 64 query
// positions of ONE query head (rows are positions; the G heads of a KV head
// read its tiles from L2); grid (ceil(Sq / 64), H, B), the q blocks issued
// last-first so the causal blocks with the most tiles start first.
//   * Q (64 x D) is copied once into shared memory and stays there; K
//     (64 x D) and V (64 x Dv) tiles of 64 keys come through a ring of
//     `Config<D, Dv>::kStages` stages (4, 3, 2, 2 at (64, 64), (128, 128),
//     (192, 128), (256, 256): what leaves room for 3, 2, 2 and 1 blocks a
//     SM; `smem_bytes`).  All are filled by 16-byte `cp.async` copies (not
//     TMA: no tensor map, no driver API, and the zero-fill below comes
//     free) into the 128-byte-swizzled layout `wgmma` reads: a tile is
//     width / 64 column blocks of 64 rows x 128 bytes, the 16-byte chunk c
//     of row r stored at chunk c ^ (r % 8), each block 1024-byte aligned.
//     A tile's rows at or beyond kv_len (the ragged Skv tail, and whatever
//     the cache holds beyond kv_len) are zero-filled, never read; q rows
//     beyond Sq likewise.
//   * S = Q K^T: `wgmma.m64n64k16` from shared memory, both operands
//     K-major, D / 16 steps over D / 64 column blocks, f32 accumulators (32
//     registers a thread).
//   * The softmax scale (times log2 e) is applied to the f32 scores, which
//     are masked in registers (causal, window, kv_len) with -inf; the row max
//     and sum reduce over the 4 threads of a quad; p = 2^(s - m).
//   * O += P V: `wgmma.m64n64k16` with P from registers (the accumulator
//     layout of S is the A-fragment layout of the next product) and V from
//     shared memory, MN-major (V's rows are keys, Dv-contiguous); Dv / 64
//     accumulators of 32 registers.
//   * Precision.  `repro` computes both products in f32
//     (`_fa_kernel`, kernel.py:71-90), and the card's check holds a bf16
//     output to one bf16 ulp + 1e-5.  Q, K and V are bf16 already, so Q K^T
//     is exact products summed in f32.  P is not: rounded once to bf16 it
//     is off by up to 2^-9 relative, and outputs near zero (sums of
//     products of both signs) miss the 1e-5.  Measured
//     (`tools/flash_kernel_probe.py precision`, PERF.md): P rounded once
//     misses the check by up to ~120x on about one output in nine at the
//     served shapes.  So P is split, p_hi = bf16(p), p_lo = bf16(p - p_hi),
//     and O += p_hi V + p_lo V keeps about 16 bits of p, at 1.5x the
//     operations of the naive design at D == Dv (3 products of the tile's
//     size in place of 2; 1.4x at (192, 128)), which the same probe
//     measures at +11% to +16% of the kernel's time.
//   * Tiles with no live key are not visited: the tile range is
//     `_fa_kernel`'s block test (beyond kv_len, after the causal diagonal of
//     the block's last query, before the window of its first).
//   * Tiles whose every key is live for every row skip the per-element
//     mask.
// There is no warp specialisation and no TMA: the 128 threads issue the
// copies of the tile kStages - 1 ahead, then compute the current one, and
// the softmax does not overlap the products of its block (at (192, 128)
// issuing the next tile's Q K^T under the softmax measured slower, and 3
// stages, one block an SM, slower still: `tools/flash_kernel_probe.py
// mla`, PERF.md).  `-Xptxas -v`: 156, 174, 191, 234 registers at (64, 64),
// (128, 128), (192, 128), (256, 256), no spills (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // one warpgroup
constexpr int kRows = 64;          // query positions per block
constexpr int kTile = 64;          // keys per tile
// stages of the K/V ring per (D, Dv): as many as leave room for a few
// blocks a SM
template <int D, int Dv> struct Config;
template <> struct Config<64, 64> { enum { kStages = 4 }; };
template <> struct Config<128, 128> { enum { kStages = 3 }; };
template <> struct Config<192, 128> { enum { kStages = 2 }; };
template <> struct Config<256, 256> { enum { kStages = 2 }; };
// dynamic shared memory: Q, kStages K and V tiles, 1024 bytes to align
template <int D, int Dv>
__host__ __device__ constexpr int smem_bytes() {
  return kRows * D * 2 + Config<D, Dv>::kStages * kTile * (D + Dv) * 2 + 1024;
}
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long B, Sq, Skv, H, KV;
  long long q_start, kv_len, window;   // kv_len <= Skv; window < 0: none
  int causal;
  float scale_log2;                    // softmax scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy to a shared address; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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
// makes the generic-proxy writes of cp.async visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (the stride between 64-wide column blocks; unused by a
// K-major operand and by an MN-major one 64 wide), stride byte offset 1024
// (8 rows of 128 bytes), layout type 1 (B128).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of 16-byte chunk c (along the row) of row r in a tile of
// `rows` rows stored as 64-wide column blocks of rows x 128 bytes
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// D (64 x 64, f32) += A (64 x 16, bf16, shared, K-major) * B (16 x 64, bf16,
// shared, K-major: B's rows are the 64 keys, each D-contiguous)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// shared, MN-major: 16 keys of V, each Dv-contiguous)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D, int Dv>
__global__ void __launch_bounds__(kThreads, 1)
    flash_prefill_kernel(Params p) {
  constexpr int kBlk = Dv / 64;                 // accumulator column blocks
  constexpr int kTileBytes = kRows * D * 2;     // Q, or one K tile
  constexpr int kVBytes = kTile * Dv * 2;       // one V tile
  constexpr int kCpr = D / 8;                   // 16-byte chunks per Q/K row
  constexpr int kVCpr = Dv / 8;                 // and per V row
  static_assert(Dv <= D, "a V row is copied beside its key's K row");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  constexpr int kStages = Config<D, Dv>::kStages;
  const uint32_t sK = sQ + kTileBytes;                  // kStages tiles
  const uint32_t sV = sK + kStages * kTileBytes;        // kStages tiles

  const long long qb = gridDim.x - 1 - blockIdx.x;      // heaviest first
  const long long h = blockIdx.y, b = blockIdx.z;
  const long long G = p.H / p.KV, kvh = h / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const long long q0 = qb * kRows;              // first query of the block
  for (int i = tid; i < kRows * kCpr; i += kThreads) {
    const int r = i / kCpr, c = i - r * kCpr;
    const bool in = q0 + r < p.Sq;
    const __nv_bfloat16* src =
        in ? p.q + ((b * p.Sq + q0 + r) * p.H + h) * D + c * 8 : p.q;
    cp_async16(sQ + swz(r, c, kRows), src, in ? 16 : 0);
  }

  // the block's live key range: [k_begin, k_end)
  const long long q_last = (q0 + kRows < p.Sq ? q0 + kRows : p.Sq) - 1;
  const long long qpos_lo = p.q_start + q0, qpos_hi = p.q_start + q_last;
  long long k_end = p.kv_len;
  if (p.causal && qpos_hi + 1 < k_end) k_end = qpos_hi + 1;
  long long k_begin = 0;
  if (p.window >= 0 && qpos_lo - p.window + 1 > 0)
    k_begin = qpos_lo - p.window + 1;
  const long long t_begin = k_begin / kTile;
  const long long t_end = k_end > k_begin ? (k_end + kTile - 1) / kTile : 0;

  auto load_kv = [&](long long t, int stage) {
    const long long kb = t * kTile;
    const uint32_t ks = sK + stage * kTileBytes, vs = sV + stage * kVBytes;
    for (int i = tid; i < kTile * kCpr; i += kThreads) {
      const int j = i / kCpr, c = i - j * kCpr;
      const bool in = kb + j < p.kv_len;
      const long long row = (b * p.Skv + kb + j) * p.KV + kvh;
      const long long off = row * D + c * 8, voff = row * Dv + c * 8;
      cp_async16(ks + swz(j, c, kTile), in ? p.k + off : p.k, in ? 16 : 0);
      if (kVCpr == kCpr || c < kVCpr)           // V's row is Dv wide
        cp_async16(vs + swz(j, c, kTile), in ? p.v + voff : p.v,
                   in ? 16 : 0);
    }
  };

  // this thread's two rows of every accumulator: r0 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  bool valid[2];
  long long qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    valid[x] = q0 + r0 + 8 * x < p.Sq;
    qpos[x] = p.q_start + q0 + r0 + 8 * x;
    m[x] = -INFINITY;
    l[x] = 0.f;
  }
  float o[kBlk][32];
#pragma unroll
  for (int c = 0; c < kBlk; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

  // the ring: tile t_begin + i goes to stage i % kStages; kStages - 1
  // tiles are in flight ahead of the one computed (the first copy group
  // also holds Q)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_begin + i < t_end) load_kv(t_begin + i, i);
    cp_async_commit();
  }
  int stage = 0;
  for (long long t = t_begin; t < t_end; ++t) {
    const int ahead = stage == 0 ? kStages - 1 : stage - 1;
    if (t + kStages - 1 < t_end) load_kv(t + kStages - 1, ahead);
    cp_async_commit();
    cp_async_wait<kStages - 1>();               // tile t has landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = sK + stage * kTileBytes, vs = sV + stage * kVBytes;
    stage = stage + 1 == kStages ? 0 : stage + 1;

    // S = Q K^T: D / 16 steps over D / 64 column blocks
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kRows * 128 + (kk & 3) * 32;
      wgmma_ss(s, make_desc(sQ + off, 16),
               make_desc(ks + (kk >> 2) * kTile * 128 + (kk & 3) * 32, 16));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // mask, scale, online softmax; register i holds row r0 + 8 * ((i >> 1)
    // & 1), key 8 * (i >> 2) + 2 * (lane & 3) + (i & 1) of the tile
    const long long kb = t * kTile;
    float mx[2] = {-INFINITY, -INFINITY};
    // a tile whose every key is live for every row of the block needs no
    // mask (uniform over the block)
    const bool full = q0 + kRows <= p.Sq && kb + kTile <= p.kv_len &&
                      (!p.causal || kb + kTile - 1 <= qpos_lo) &&
                      (p.window < 0 || kb > qpos_hi - p.window);
    if (full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] *= p.scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int x = (i >> 1) & 1;
        const long long kj = kb + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        bool live = valid[x] && kj < p.kv_len;
        if (p.causal) live = live && kj <= qpos[x];
        if (p.window >= 0) live = live && kj > qpos[x] - p.window;
        s[i] = live ? s[i] * p.scale_log2 : -INFINITY;
        mx[x] = fmaxf(mx[x], s[i]);
      }
    }
    float corr[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      const float m_new = fmaxf(m[x], mx[x]);
      corr[x] = 1.f;
      if (m_new != -INFINITY) {
        corr[x] = exp2f(m[x] - m_new);          // 0 while no live key yet
        m[x] = m_new;
      }
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int x = (i >> 1) & 1;
      s[i] = m[x] == -INFINITY ? 0.f : exp2f(s[i] - m[x]);   // -inf -> 0
      rs[x] += s[i];
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) l[x] = l[x] * corr[x] + rs[x];
#pragma unroll
    for (int c = 0; c < kBlk; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];

    // O += P V, P split into bf16 hi and lo parts: all A fragments are
    // built before the first product is issued, so none is rewritten while
    // a product that reads it is in flight
    uint32_t hi[kTile / 16][4], lo[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = s[8 * kk + 2 * e], bb = s[8 * kk + 2 * e + 1];
        hi[kk][e] = pack_bf16(a, bb);
        const __nv_bfloat162 hv =
            *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][e]);
        lo[kk][e] = pack_bf16(a - __low2float(hv), bb - __high2float(hv));
      }
#pragma unroll
    for (int c = 0; c < kBlk; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kBlk; ++c) {
        const uint64_t dv = make_desc(vs + c * kTile * 128 + kk * 16 * 128,
                                      kTile * 128);
        wgmma_rs(o[c], hi[kk], dv);
        wgmma_rs(o[c], lo[kk], dv);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < kBlk; ++c) fence_regs(o[c]);
    __syncthreads();                            // the stage may be refilled
  }
  cp_async_wait<0>();

  // out = O / max(l, 1e-30), l summed over the quad
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    l[x] = fmaxf(l[x], 1e-30f);
  }
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (!valid[x]) continue;
    __nv_bfloat16* orow =
        p.o + ((b * p.Sq + q0 + r0 + 8 * x) * p.H + h) * Dv + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < kBlk; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a = o[c][4 * j + 2 * x] / l[x];
        const float bb = o[c][4 * j + 2 * x + 1] / l[x];
        *reinterpret_cast<__nv_bfloat162*>(orow + c * 64 + 8 * j) =
            __floats2bfloat162_rn(a, bb);
      }
  }
}

template <int D, int Dv>
int launch(const Params& p, cudaStream_t stream) {
  const int smem = smem_bytes<D, Dv>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_prefill_kernel<D, Dv>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((p.Sq + kRows - 1) / kRows), (unsigned)p.H,
                  (unsigned)p.B);
  flash_prefill_kernel<D, Dv><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted).  Sizes are elements; the wrapper has checked shapes, dtypes
// (bf16) and contiguity.
int repro_flash_prefill_sm90(const void* q, const void* k, const void* v,
                             void* o, long long B, long long Sq, long long Skv,
                             long long H, long long KV, long long D,
                             long long Dv, long long q_start, long long kv_len,
                             long long window, int causal, float scale,
                             void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV;
  p.q_start = q_start;
  p.kv_len = kv_len < Skv ? kv_len : Skv;
  p.window = window;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && Dv == 64) return launch<64, 64>(p, s);
  if (D == 128 && Dv == 128) return launch<128, 128>(p, s);
  if (D == 192 && Dv == 128) return launch<192, 128>(p, s);
  if (D == 256 && Dv == 256) return launch<256, 256>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
