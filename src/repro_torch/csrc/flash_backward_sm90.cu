// Tensor-core backward of GQA flash attention for Hopper (sm_90a), plain C
// interface.
//
// No TPU kernel precedes it: the JAX package has no backward kernel; its
// train step differentiates `_flash_xla` (src/repro/kernels/flash_attention/
// ops.py:77) with XLA, `jax.grad`.  This kernel computes that gradient for
// the training forms of the forward, bf16, q_start 0:
//   * causal, Sq = Skv = S, with or without a local window W (keys at or
//     before q - W masked, as in the forward), at (D, Dv) = (64, 64)
//     (llama3.2-1b, granite-moe-3b-a800m), (128, 128) (starcoder2-7b: 36
//     query heads over 4 KV heads; granite-20b: 48 over 1; chameleon-34b:
//     64 over 8), (192, 128) (deepseek-v3-671b's MLA in training: 128 heads
//     of 128 + 64 dims of q and k, 128 of v, each its own KV head) and
//     (256, 256) (gemma-7b; recurrentgemma-2b: 10 query heads over 1 KV
//     head, W 2048);
//   * non-causal, any Sq and Skv, no window, at (64, 64) (seamless-m4t-
//     medium: its encoder's self-attention, and its decoder's
//     cross-attention from Sq text positions over Skv encoder frames).
// Given q (B,Sq,H,D), k (B,Skv,KV,D), v (B,Skv,KV,Dv), the forward's output
// o (B,Sq,H,Dv) and the output's gradient dO (B,Sq,H,Dv), with P =
// softmax(scale * q k^T) under the mask (scale the caller's: MLA's is
// (128 + 64)^-0.5), it returns
//   dV = P^T dO,  dS = P * (dO v^T - rowsum(dO * o)),
//   dQ = scale * dS k,  dK = scale * dS^T q,
// summed over the G = H / KV query heads that share a KV head; sums in f32,
// outputs bf16.  flash_backward.cu computes the same on CUDA cores and
// keeps the f32 calls.
//
// What bounds it on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 dense): at
// llama3.2-1b's training shape (B 8, S 256, H 32, KV 8, D 64) one layer's
// backward must read q, k, v, o and dO and write dq, dk and dv, 41.9 MB,
// 12.5 us; its five products over the causal (query, key) pairs are 5.4
// GFLOP, 5.4 us on the tensor cores.  So bytes bound it.  At Griffin's
// (B 8, S 256, H 10, KV 1, D 256) the window does not bite: 46.1 MB, 13.8
// us (bytes); at B 1, S 4096, W 2048, 6,292,480 live pairs a head, 161
// GFLOP, 163 us (operations).  At starcoder2-7b's (B 8, S 256, H 36, KV 4,
// D 128): 83.9 MB, 25.0 us (bytes; 12.1 GFLOP, 12.3 us).  seamless's
// encoder (B 8, S 256, H 16, KV 16, non-causal): 33.6 MB, 10.0 us (bytes;
// 5.37 GFLOP, 5.4 us); its cross-attention (Sq 256, Skv 384): 41.9 MB,
// 12.5 us (8.05 GFLOP, 8.1 us).  deepseek's MLA (B 8, S 256, H 128, KV
// 128, (192, 128)): 671 MB, 200 us (bytes; 56.0 GFLOP, 56.7 us).  The
// design keeps every product on the tensor cores and every intermediate
// (S, P, dP, dS) in registers, and reads each input from device memory
// about once (the tiles that several blocks share come from L2).
//
// Design: two kernels, launched in order on one stream by one entry, no
// atomics (the G heads of a KV head are summed in a fixed order inside one
// block, so a replay gives the same bits).  A block is one warpgroup (128
// threads); every product is `wgmma.m64n64k16` (bf16 in, f32 sums), 64 rows
// a tile and 64 columns an accumulator:
//   * dQ: one block per (batch, head, 64 query rows, 64 columns of dQ).  Its
//     first sweep over the live key tiles computes S = Q K^T only, and each
//     row's log-sum-exp by an online max and sum (base 2); D = rowsum(dO *
//     o) comes from the dO tile and an o tile copied with it, each row's
//     quad of threads summing a quarter of it.  Non-causal, the first sweep
//     also computes dP = dO V^T and D = sum P dP by an online sum beside
//     the max's, and o is not read: seamless-m4t-medium's cross-attention
//     reads an encoder output whose rows nearly coincide, so dP - D
//     cancels to ~1/2000 of dP, and o rounded to bf16 put its rounding
//     into dS at ~2000x (the gradient of its wq and wk read 8.6 from the
//     f32 one where the plain bf16 path read 0.13; tools/
//     last_families_probe.py noise, PERF.md section 6).  The column block
//     0 writes both to f32 scratch (B, H, Sq rounded up to 64) for the
//     dK/dV kernel: no separate setup pass.  Its second sweep computes S and dP = dO V^T,
//     then P = 2^(S scale log2 e - lse) and dS = P (dP - D) in registers,
//     then dQ[:, cols] += dS K[:, cols];
//   * dK/dV: one block per (batch, KV head, 64 keys, 64 columns of dK and
//     dV) loops over the G query heads of its KV head, then over the live
//     query tiles of its keys: S^T = K Q^T and dP^T = V dO^T, then P^T and
//     dS^T in registers, then dV[:, cols] += P^T dO[:, cols] and dK[:,
//     cols] += dS^T Q[:, cols].  dK and dV stay in registers over all G x
//     tiles steps.
// Past D 64 one warpgroup cannot hold a 64 x D f32 accumulator beside S
// and dP (64 registers a thread at D 128, 128 at D 256, for it alone), so
// the D / 64 column blocks of a tile are blocks of their own, each
// recomputing S over the full D and dP over the full Dv.  Counting the
// bound's five products once (S, dP, dV, dK, dQ) against what the blocks
// do (S in both sweeps of the dQ kernel and in the dK/dV kernel, dP in
// both kernels, each per column block, and the three outputs once): 1.6x
// at D 64, 2.6x at D 128, 4.6x at D 256, the price of the accumulators'
// registers.  At (192, 128) a tile of q or k has 3 column blocks and one
// of v, o or dO 2: each block of either kernel recomputes S over 192
// columns and dP over 128, the dK/dV kernel's first 2 blocks also hold
// dV's columns and its third dK's alone (3.6x).
// The masks.  Causal: a dQ block visits the key tiles from the first that
// holds a key inside its first row's window to its diagonal; a dK/dV block
// the query tiles from its diagonal to the last whose last row's window
// reaches its first key (`kernel.py:backward_key_tiles`,
// `backward_query_tiles`).  Non-causal: a dQ block visits every key tile
// of Skv, a dK/dV block every query tile of Sq, in the same fixed order;
// keys at or past Skv are masked in the dQ kernel's softmax and dP (their
// rows of K and V are zero-filled, not -inf), queries at or past Sq in
// both.  Masks are per element only on the diagonal, band-edge and ragged
// tiles.  Each kernel is built for each form it takes (kCausal, kWin): a
// call whose window cuts no key (none given, or one of S or more) runs the
// code without the window's tests (the D 64 dK/dV kernel: 197 registers
// without them, 205 with), a non-causal call the code without the
// diagonal's.
// Operands.  S, dP, S^T and dP^T take both operands from shared memory,
// K-major (rows D-contiguous).  dQ, dV and dK take A from registers (the
// accumulator layout of the previous product, rounded to bf16, is the
// A-fragment layout of the next) and B from shared memory, MN-major: the
// same swizzled Q, dO and K tiles serve as K-major B of one product and
// MN-major B of the next, under two descriptors.  A tile of D columns is
// stored as D / 64 column blocks of 64 rows x 128 bytes (flash_prefill_
// sm90.cu's layout), a tile of v, o or dO as Dv / 64.  P and dS enter the
// products as bf16 (2^-9 relative each; the card's check holds each
// gradient to 4 bf16 ulps of its largest value).
// Copies.  Tiles come through a ring of stages of 16-byte `cp.async`
// copies into the 128-byte-swizzled layout `wgmma` reads, rows at or past
// Sq (queries) or Skv (keys) zero-filled; the ring's tiles are stages - 1
// ahead of the one computed.  The dK/dV kernel's ring also carries the 64
// log-sum-exps and D of each query tile.
// Outputs are staged through shared memory as bf16 and stored 16 bytes a
// thread.
// Block order.  A 1-D grid, heaviest blocks first: the dQ blocks of the last
// query tile (causal: the most key tiles) over every (batch, head, column
// block), then the tile before; the dK/dV blocks of key tile 0 (the most
// query tiles) first.  A window keeps that order heaviest first: a later
// query tile never has fewer key tiles, a later key tile never more query
// tiles.  Non-causal blocks all have the same work.
// Occupancy.  `-Xptxas -v` for sm_90a (tools/last_families_probe.py
// check), no spills anywhere, registers dQ / dK/dV without (with) the
// window's tests: (64, 64) 128 (128) / 190 (204), the dQ kernel held at 128
// by its launch bounds for four blocks an SM; non-causal (64, 64) three
// blocks an SM (at four's 128 registers its dQ kernel spilled 12 bytes:
// its first sweep holds dP too; PERF.md section 6) / 188; (128, 128) 151 (155) / 186 (192), two blocks an SM each, by shared
// memory (99,328 and 100,352 bytes; a third stage would leave one); (192,
// 128) 156 (165) / 208 (184) and (256, 256) 149 (155) / 186 (192), one
// block an SM each, by shared memory (123,904 and 124,928 bytes at (192,
// 128), so two stages).  What limits each at D 64,
// from clock stamps on an H100 (tools/flash_backward_probe.py variants,
// PERF.md): the dQ blocks are short (2 to 2n steps) and wait on their
// copies from L2; a dK/dV block is a chain of G x tiles dependent steps
// (copy, products, softmax, products), two blocks an SM.  That chain is
// what granite-20b's heads (G 48 over one KV head) make long: at B 8, S
// 256 the dK/dV grid is 64 blocks for 132 SMs, each up to 192 steps
// (PERF.md section 6, row 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // one warpgroup
constexpr int kTile = 64;          // rows of every tile: queries or keys
constexpr int kCol = 64;           // columns of an accumulator block
constexpr int kPanelBytes = kTile * kCol * 2;  // a 64 x 64 bf16 column block
constexpr int kStatBytes = 2 * kTile * 4;     // lse and D of a query tile
constexpr float kLog2e = 1.4426950408889634f;

// per head dims (D of q and k, Dv of v): the stages of the dQ kernel's K/V
// ring and of the dK/dV kernel's Q/dO ring, and the dQ blocks an SM its
// launch bounds aim at (registers)
template <int kD, int kDv> struct Config;
template <> struct Config<64, 64> {
  static constexpr int kDqStages = 2, kDkdvStages = 3, kDqBlocks = 4;
};
template <> struct Config<128, 128> {
  static constexpr int kDqStages = 2, kDkdvStages = 2, kDqBlocks = 2;
};
template <> struct Config<192, 128> {
  static constexpr int kDqStages = 2, kDkdvStages = 2, kDqBlocks = 1;
};
template <> struct Config<256, 256> {
  static constexpr int kDqStages = 2, kDkdvStages = 2, kDqBlocks = 1;
};

// bytes of a 64-row tile of W columns, and the dynamic shared memory of
// each kernel: its resident tiles (a D-wide and a Dv-wide one), its ring
// (a D-wide and a Dv-wide tile a stage), and 1024 bytes to align the
// swizzled tiles
template <int kW>
__host__ __device__ constexpr int tile_bytes() { return kTile * kW * 2; }
template <int kD, int kDv>
__host__ __device__ constexpr int dq_smem() {
  return (1 + Config<kD, kDv>::kDqStages) *
             (tile_bytes<kD>() + tile_bytes<kDv>()) + 1024;
}
template <int kD, int kDv>
__host__ __device__ constexpr int dkdv_smem() {
  return (1 + Config<kD, kDv>::kDkdvStages) *
             (tile_bytes<kD>() + tile_bytes<kDv>()) +
         Config<kD, kDv>::kDkdvStages * kStatBytes + 1024;
}
static_assert(dq_smem<128, 128>() <= 232448 &&
                  dkdv_smem<128, 128>() <= 232448 &&
                  dq_smem<192, 128>() <= 232448 &&
                  dkdv_smem<192, 128>() <= 232448 &&
                  dq_smem<256, 256>() <= 232448 &&
                  dkdv_smem<256, 256>() <= 232448,
              "a block's shared memory");
// the dQ blocks an SM the dQ kernel's launch bounds aim at: Config's, and
// non-causal at most three (its first sweep holds dP too: held to four
// blocks' 128 registers it spilled)
template <int kD, int kDv, bool kCausal>
__host__ __device__ constexpr int dq_min_blocks() {
  return kCausal || Config<kD, kDv>::kDqBlocks < 3
             ? Config<kD, kDv>::kDqBlocks : 3;
}
// (128, 128)'s two blocks an SM of each kernel (an SM's 233,472 bytes, 1024
// of them reserved a block)
static_assert(Config<128, 128>::kDqBlocks * (dq_smem<128, 128>() + 1024) <=
                      233472 &&
                  2 * (dkdv_smem<128, 128>() + 1024) <= 233472,
              "two blocks an SM at (128, 128)");

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* lse;                // (B, H, Spad), base 2 and scaled
  float* delta;              // (B, H, Spad)
  long long B, Sq, Skv, H, KV;
  long long Spad;            // Sq rounded up to a tile
  long long qtiles, ktiles;  // tiles of Sq queries, of Skv keys
  long long window;          // keys at or before q - window masked (kWin)
  float scale, scale_log2;
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
// byte offset (unused by a K-major operand and by an MN-major one 64 wide),
// stride byte offset 1024 (8 rows of 128 bytes), layout type 1 (B128).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
// k-step kk (16 of the D dims) of a K-major tile: rows D-contiguous, kk / 4
// the column block
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16);
}
// k-step kk (16 of the 64 rows) of column block `col` of an MN-major tile:
// rows are the sum's index, each D-contiguous
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int col) {
  return make_desc(tile + col * kPanelBytes + kk * 16 * 128, kTile * 128);
}

// byte offset of 16-byte chunk c of row r in a 64-row bf16 tile stored as
// column blocks of 64 rows x 128 bytes
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 3) * kPanelBytes + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// D (64 x 64, f32) += A (64 x 16, bf16, shared, K-major) * B (16 x 64, bf16,
// shared, K-major)
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
// shared, MN-major)
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

// 2^x by the special function unit (flushes to 0 below 2^-126; -inf
// gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// A = X Y^T (64 x 64) over kD and B = U W^T over kDv, both from shared
// memory, K-major, in one batch of products
template <int kD, int kDv>
__device__ __forceinline__ void two_products_ss(float (&a)[32], uint32_t x,
                                                uint32_t y, float (&b)[32],
                                                uint32_t u, uint32_t w) {
  zero(a);
  zero(b);
  fence_regs(a);
  fence_regs(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(a, desc_k(x, kk), desc_k(y, kk));
#pragma unroll
  for (int kk = 0; kk < kDv / 16; ++kk)
    wgmma_ss(b, desc_k(u, kk), desc_k(w, kk));
  wgmma_commit();
  wgmma_wait0();
  fence_regs(a);
  fence_regs(b);
}

// the A fragments (bf16) of a 64 x 64 accumulator, one per k-step of 16
__device__ __forceinline__ void to_frags(const float (&d)[32],
                                         uint32_t (&a)[kTile / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

// rows row0 .. row0 + 63 of a (S x kW) bf16 matrix whose row r starts at
// base + r * stride, into a swizzled tile; rows at or past S zero-filled.
// Thread t copies 16-byte chunk t % 8 of each column block of rows t / 8 +
// 16 i, i < 4: one address computed, then steps of 16 rows (the swizzle
// repeats every 8) and of a column block
template <int kW>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long row0, long long S,
                                          long long stride, int tid) {
  const int r = tid >> 3, c = tid & 7;
  const __nv_bfloat16* src = base + (row0 + r) * stride + c * 8;
  const uint32_t d = dst + swz(r, c);
  const int left = (int)(S - row0 - r);        // rows of this thread in S
#pragma unroll
  for (int cb = 0; cb < kW / kCol; ++cb)
#pragma unroll
    for (int i = 0; i < kTile / 16; ++i) {
      const bool in = 16 * i < left;
      cp_async16(d + cb * kPanelBytes + i * 16 * 128,
                 in ? src + i * 16 * stride + cb * kCol : base, in ? 16 : 0);
    }
}

// the 16-byte chunk c of row r of a swizzled tile at shared address `tile`,
// through a generic pointer (`smem` is the dynamic shared memory's start)
__device__ __forceinline__ uint4* chunk(unsigned char* smem, uint32_t tile,
                                        int r, int c) {
  return reinterpret_cast<uint4*>(smem + (tile - smem_u32(smem)) +
                                  swz(r, c));
}

// A 64 x 64 f32 accumulator (this thread's rows r0 and r0 + 8) times
// `scale`, as bf16 into the first column block of a swizzled tile at shared
// address `tile`
__device__ __forceinline__ void stage_out(unsigned char* smem, uint32_t tile,
                                          const float (&d)[32], float scale,
                                          int r0, int lane) {
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(
          reinterpret_cast<unsigned char*>(chunk(smem, tile, r0 + 8 * x, jj)) +
          4 * (lane & 3)) =
          __floats2bfloat162_rn(d[4 * jj + 2 * x] * scale,
                                d[4 * jj + 2 * x + 1] * scale);
}

// The rows of a staged 64 x 64 block to rows row0 .. of a bf16 matrix (row
// r's 64 columns at base + r * stride), 16 bytes a thread, rows at or past
// S left out
__device__ __forceinline__ void store_tile(__nv_bfloat16* base,
                                           unsigned char* smem, uint32_t tile,
                                           long long row0, long long S,
                                           long long stride, int tid) {
  const int r = tid >> 3, c = tid & 7;
#pragma unroll
  for (int i = 0; i < kTile / 16; ++i)
    if (row0 + r + 16 * i < S)
      *reinterpret_cast<uint4*>(base + (row0 + r + 16 * i) * stride + c * 8) =
          *chunk(smem, tile, r + 16 * i, c);
}

// Block i of the dQ grid: query tile (the last first), then (batch row,
// head, column block), the column block fastest (kCols of them)
template <int kCols>
__device__ __forceinline__ void dq_block(long long i, const Params& p,
                                         long long& b, long long& h,
                                         long long& qt, int& col) {
  const long long pairs = p.B * p.H * kCols, r = i / pairs;
  const long long pair = i - r * pairs, bh = pair / kCols;
  qt = p.qtiles - 1 - r;
  col = (int)(pair - bh * kCols);
  b = bh / p.H;
  h = bh - b * p.H;
}

// Block i of the dK/dV grid: key tile (0 first), then (batch row, KV head,
// column block)
template <int kCols>
__device__ __forceinline__ void dkdv_block(long long i, const Params& p,
                                           long long& b, long long& kvh,
                                           long long& kt, int& col) {
  const long long pairs = p.B * p.KV * kCols, r = i / pairs;
  const long long pair = i - r * pairs, bk = pair / kCols;
  kt = r;
  col = (int)(pair - bk * kCols);
  b = bk / p.KV;
  kvh = bk - b * p.KV;
}

// dQ of 64 query rows and 64 columns of one head, and (column block 0)
// their log-sum-exp and D into the scratch.  The block's key tiles are t0 ..
// t0 + n - 1: causal, the window's first to the diagonal qt (without a
// window, kWin false, from 0); non-causal, every key tile of Skv.  Steps 0
// .. n-1 sweep them for the log-sum-exp (K only); steps n .. 2n-1 sweep
// them again for dQ (K and V).
template <int kD, int kDv, bool kWin, bool kCausal>
__global__ void __launch_bounds__(kThreads,
                                  (dq_min_blocks<kD, kDv, kCausal>()))
    bwd_dq_sm90_kernel(Params p) {
  constexpr int kStages = Config<kD, kDv>::kDqStages;
  constexpr int kTB = tile_bytes<kD>(), kVB = tile_bytes<kDv>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sdO = sQ + kTB;
  const uint32_t sK = sdO + kVB;                 // kStages tiles
  const uint32_t sV = sK + kStages * kTB;        // kStages tiles

  long long b, h, qt;
  int col;
  dq_block<kD / kCol>(blockIdx.x, p, b, h, qt, col);
  const long long Sq = p.Sq, Skv = p.Skv, H = p.H, KV = p.KV;
  const long long kvh = h / (H / KV), W = p.window;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long q0 = qt * kTile;
  const __nv_bfloat16* qb = p.q + (b * Sq * H + h) * kD;
  const __nv_bfloat16* db = p.dout + (b * Sq * H + h) * kDv;
  const __nv_bfloat16* kb = p.k + (b * Skv * KV + kvh) * kD;
  const __nv_bfloat16* vb = p.v + (b * Skv * KV + kvh) * kDv;
  load_tile<kD>(sQ, qb, q0, Sq, H * kD, tid);
  load_tile<kDv>(sdO, db, q0, Sq, H * kDv, tid);
  // causal: o's rows into stage 0's V slot, which no step fills before
  // step 2 (sweep 2 starts at step n >= 1; step 1, if it is the first of
  // sweep 2, takes stage 1); D is summed from it in step 0.  Non-causal:
  // D comes from sweep 1's P and dP, and o is not read
  if (kCausal)
    load_tile<kDv>(sV, p.o + (b * Sq * H + h) * kDv, q0, Sq, H * kDv, tid);

  // the live key tiles: causal, from the one holding the first row's first
  // key in its window to the diagonal; non-causal, all of them
  const long long t0 =
      kCausal && kWin && q0 - W + 1 > 0 ? (q0 - W + 1) / kTile : 0;
  const long long n = kCausal ? qt - t0 + 1 : p.ktiles;
  auto load_step = [&](long long j, int stage) {
    const long long t = t0 + (j < n ? j : j - n);
    load_tile<kD>(sK + stage * kTB, kb, t * kTile, Skv, KV * kD, tid);
    if (j >= n || !kCausal)
      load_tile<kDv>(sV + stage * kVB, vb, t * kTile, Skv, KV * kDv, tid);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < 2 * n) load_step(i, i);
    cp_async_commit();
  }

  // this thread's two rows of every accumulator: r0 and r0 + 8
  const int r0 = warp * 16 + (lane >> 2);
  bool valid[2];
  int qpos[2];            // positions fit an int: Sq, Skv < 2^31
  // dsum: non-causal, the online sum of 2^(s - m) dP, whose ratio to l is
  // D = sum P dP
  float m[2], l[2], lse[2], del[2], dsum[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    qpos[x] = (int)q0 + r0 + 8 * x;
    valid[x] = qpos[x] < Sq;
    m[x] = -INFINITY;
    l[x] = lse[x] = dsum[x] = del[x] = 0.f;
  }
  const int w = (int)(kWin && W < Skv ? W : Skv);  // the window, cut to S
  // whether key kj is live for this thread's row x (a valid row): causal,
  // at or before it and inside its window; non-causal, a key of Skv
  auto live = [&](int kj, int x) {
    return kCausal ? kj <= qpos[x] && (!kWin || kj > qpos[x] - w)
                   : kj < (int)Skv;
  };

  float dq[32];
  zero(dq);
  const bool rows_full = q0 + kTile <= Sq;
  int stage = 0;
  for (long long j = 0; j < 2 * n; ++j) {
    const int ahead = stage == 0 ? kStages - 1 : stage - 1;
    if (j + kStages - 1 < 2 * n) load_step(j + kStages - 1, ahead);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                // step j's tiles have landed
    fence_proxy_async();
    __syncthreads();
    if (kCausal && j == 0) {
      // D = rowsum(dO * o) from the tiles: each thread of a row's quad
      // sums a quarter of its dims (rows past Sq are zeros)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float acc = 0.f;
#pragma unroll
        for (int cb = 0; cb < kDv / kCol; ++cb)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int c = 8 * cb + 2 * (lane & 3) + cc;
            const uint4 ou = *chunk(smem_raw, sV, r0 + 8 * x, c);
            const uint4 du = *chunk(smem_raw, sdO, r0 + 8 * x, c);
            const __nv_bfloat162* o2 =
                reinterpret_cast<const __nv_bfloat162*>(&ou);
            const __nv_bfloat162* d2 =
                reinterpret_cast<const __nv_bfloat162*>(&du);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 of = __bfloat1622float2(o2[e]);
              const float2 df = __bfloat1622float2(d2[e]);
              acc = fmaf(of.x, df.x, acc);
              acc = fmaf(of.y, df.y, acc);
            }
          }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        del[x] = acc;
      }
    }
    const uint32_t ks = sK + stage * kTB, vs = sV + stage * kVB;
    stage = stage + 1 == kStages ? 0 : stage + 1;
    const long long t = t0 + (j < n ? j : j - n), k0 = t * kTile;
    // every key of the tile is live for every row (uniform over the block):
    // causal, below the diagonal and inside the last row's window;
    // non-causal, the tile inside Skv
    const bool full =
        rows_full && (kCausal ? t < qt && (!kWin || k0 + w > q0 + kTile - 1)
                              : k0 + kTile <= Skv);

    // register i holds row r0 + 8 * ((i >> 1) & 1), key 8 * (i >> 2) +
    // 2 * (lane & 3) + (i & 1) of the tile
    float s[32], dp[32];
    if (j < n) {
      // sweep 1: S = Q K^T, an online max and sum of 2^(s scale log2 e);
      // non-causal, also dP = dO V^T and the online sum of 2^(s - m) dP
      if (kCausal) {
        zero(s);
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          wgmma_ss(s, desc_k(sQ, kk), desc_k(ks, kk));
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);
      } else {
        two_products_ss<kD, kDv>(s, sQ, ks, dp, sdO, vs);
      }
      float mx[2] = {-INFINITY, -INFINITY};
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
          const int kj = (int)k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          s[i] = valid[x] && live(kj, x) ? s[i] * p.scale_log2 : -INFINITY;
          mx[x] = fmaxf(mx[x], s[i]);
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
        mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
        const float m_new = fmaxf(m[x], mx[x]);
        if (m_new == -INFINITY) continue;        // no live key yet
        float rs = 0.f, rd = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == x) {
            const float e = ex2(s[i] - m_new);   // -inf -> 0
            rs += e;
            if (!kCausal) rd = fmaf(e, dp[i], rd);
          }
        const float c = ex2(m[x] - m_new);       // 0 while m was -inf
        l[x] = l[x] * c + rs;
        if (!kCausal) dsum[x] = dsum[x] * c + rd;
        m[x] = m_new;
      }
      if (j == n - 1) {
        // the log-sum-exp (base 2, of the scaled scores), and D, to the
        // scratch (column block 0); rows past Sq get 0 there and are
        // masked everywhere
        const long long row = (b * H + h) * p.Spad + q0 + r0;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
          l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
          lse[x] = valid[x] ? m[x] + log2f(l[x]) : 0.f;
          if (!kCausal) {
            // D = sum P dP, of this sweep's own P and dP: rowsum(dO * o)
            // with o rounded to bf16 loses D where dP - D cancels (keys
            // whose values nearly coincide: an encoder output whose rows
            // have collapsed)
            dsum[x] += __shfl_xor_sync(0xffffffffu, dsum[x], 1);
            dsum[x] += __shfl_xor_sync(0xffffffffu, dsum[x], 2);
            del[x] = valid[x] ? dsum[x] / l[x] : 0.f;
          }
          if (col == 0 && (lane & 3) == 0) {
            p.lse[row + 8 * x] = lse[x];
            p.delta[row + 8 * x] = valid[x] ? del[x] : 0.f;
          }
        }
      }
    } else {
      // sweep 2: S and dP = dO V^T, P and dS in registers, dQ += dS K
      two_products_ss<kD, kDv>(s, sQ, ks, dp, sdO, vs);
      if (full) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int x = (i >> 1) & 1;
          dp[i] = ex2(s[i] * p.scale_log2 - lse[x]) * (dp[i] - del[x]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int x = (i >> 1) & 1;
          const int kj = (int)k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          const float pr = valid[x] && live(kj, x)
                               ? ex2(s[i] * p.scale_log2 - lse[x]) : 0.f;
          dp[i] = pr * (dp[i] - del[x]);
        }
      }
      uint32_t a[kTile / 16][4];
      to_frags(dp, a);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_rs(dq, a[kk], desc_mn(ks, kk, col));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dq);
    }
    __syncthreads();                             // the stage may be refilled
  }
  cp_async_wait<0>();

  // dQ through the Q tile's shared memory, for 16-byte stores
  stage_out(smem_raw, sQ, dq, p.scale, r0, lane);
  __syncthreads();
  store_tile(p.dq + (b * Sq * H + h) * kD + col * kCol, smem_raw, sQ, q0, Sq,
             H * kD, tid);
}

// dK and dV of 64 keys and 64 columns of one KV head (at D > Dv the column
// blocks past Dv's hold dK's columns alone).  The block's query tiles are
// qf .. qf + nq - 1: causal, the diagonal kt to the last whose window
// reaches its first key; non-causal, every query tile of Sq.  Step j takes
// head g = j / nq of the KV head's G and query tile qf + j % nq.
template <int kD, int kDv, bool kWin, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv_sm90_kernel(Params p) {
  constexpr int kStages = Config<kD, kDv>::kDkdvStages;
  constexpr int kTB = tile_bytes<kD>(), kVB = tile_bytes<kDv>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = base, sV = sK + kTB;
  const uint32_t sQ = sV + kVB;                  // kStages tiles
  const uint32_t sdO = sQ + kStages * kTB;       // kStages tiles
  const uint32_t sSt = sdO + kStages * kVB;      // kStages stats
  const float* stats = reinterpret_cast<const float*>(
      smem_raw + (sSt - smem_u32(smem_raw)));

  long long b, kvh, kt;
  int col;
  dkdv_block<kD / kCol>(blockIdx.x, p, b, kvh, kt, col);
  const long long Sq = p.Sq, Skv = p.Skv, H = p.H, KV = p.KV, G = H / KV;
  const long long W = p.window;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // whether this block holds dV's columns too (uniform over the block)
  const bool has_v = kDv == kD || col < kDv / kCol;
  const long long k0 = kt * kTile;
  load_tile<kD>(sK, p.k + (b * Skv * KV + kvh) * kD, k0, Skv, KV * kD, tid);
  load_tile<kDv>(sV, p.v + (b * Skv * KV + kvh) * kDv, k0, Skv, KV * kDv,
                 tid);

  // the live query tiles: causal, the diagonal to the one holding the last
  // query whose window reaches the block's last key; non-causal, all
  const long long qf = kCausal ? kt : 0;
  long long t1 = kCausal && kWin ? (k0 + kTile - 1 + W - 1) / kTile
                                 : p.qtiles - 1;
  if (t1 > p.qtiles - 1) t1 = p.qtiles - 1;
  const long long nq = t1 - qf + 1, n = G * nq;
  auto load_step = [&](long long j, int stage) {
    const long long g = j / nq, qt = qf + j - g * nq, h = kvh * G + g;
    const long long row0 = qt * kTile;
    load_tile<kD>(sQ + stage * kTB, p.q + (b * Sq * H + h) * kD, row0, Sq,
                  H * kD, tid);
    load_tile<kDv>(sdO + stage * kVB, p.dout + (b * Sq * H + h) * kDv, row0,
                   Sq, H * kDv, tid);
    // the tile's 64 log-sum-exps, then its 64 D (the scratch is padded to
    // whole tiles)
    if (tid < 2 * kTile / 4) {
      const float* src = (tid < kTile / 4 ? p.lse : p.delta) +
                         (b * H + h) * p.Spad + row0 + 4 * (tid % (kTile / 4));
      cp_async16(sSt + stage * kStatBytes + 16 * tid, src, 16);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load_step(i, i);
    cp_async_commit();
  }

  // this thread's two keys (accumulator rows) r0 and r0 + 8; register i
  // of S^T holds key r0 + 8 * ((i >> 1) & 1), query 8 * (i >> 2) +
  // 2 * (lane & 3) + (i & 1) of the query tile
  const int r0 = warp * 16 + (lane >> 2);
  int kpos[2];            // positions fit an int: Sq, Skv < 2^31
#pragma unroll
  for (int x = 0; x < 2; ++x) kpos[x] = (int)k0 + r0 + 8 * x;
  const int w = (int)(kWin && W < Skv ? W : Skv);  // the window, cut to S
  float dk[32], dv[32];
  zero(dk);
  zero(dv);
  int stage = 0;
  for (long long j = 0; j < n; ++j) {
    const int ahead = stage == 0 ? kStages - 1 : stage - 1;
    if (j + kStages - 1 < n) load_step(j + kStages - 1, ahead);
    cp_async_commit();
    cp_async_wait<kStages - 1>();                // step j's tiles have landed
    fence_proxy_async();
    __syncthreads();
    const uint32_t qs = sQ + stage * kTB;
    const uint32_t dos = sdO + stage * kVB;
    const float* lse = stats + stage * (kStatBytes / 4);
    const float* del = lse + kTile;
    stage = stage + 1 == kStages ? 0 : stage + 1;
    const long long g = j / nq, q0 = (qf + j - g * nq) * kTile;
    // every query of the tile sees every key of the block: causal, past the
    // diagonal and the last query's window reaching the first key;
    // non-causal, both tiles inside their sequences
    const bool full =
        q0 + kTile <= Sq &&
        (kCausal ? q0 > k0 && (!kWin || q0 + kTile - 1 - k0 < w)
                 : k0 + kTile <= Skv);

    // S^T = K Q^T and dP^T = V dO^T
    float st[32], dpt[32];
    two_products_ss<kD, kDv>(st, sK, qs, dpt, sV, dos);
    // P^T = 2^(s scale log2 e - lse) and dS^T = P^T (dP^T - D), queries
    // past Sq and (causal) keys after a query or at or before its window,
    // (non-causal) keys past Skv, giving 0
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * (lane & 3);
      const float2 lq = *reinterpret_cast<const float2*>(lse + c);
      const float2 dd = *reinterpret_cast<const float2*>(del + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jj + e, x = (e >> 1) & 1, y = e & 1;
        const int qi = (int)q0 + c + y;
        float pr = ex2(st[i] * p.scale_log2 - (y ? lq.y : lq.x));
        if (!full)
          pr = qi < (int)Sq &&
                       (kCausal ? kpos[x] <= qi && (!kWin || kpos[x] > qi - w)
                                : kpos[x] < (int)Skv)
                   ? pr : 0.f;
        st[i] = pr;
        dpt[i] = pr * (dpt[i] - (y ? dd.y : dd.x));
      }
    }
    // dV += P^T dO, dK += dS^T Q (the block's columns)
    uint32_t pa[kTile / 16][4], sa[kTile / 16][4];
    to_frags(st, pa);
    to_frags(dpt, sa);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      if (has_v) wgmma_rs(dv, pa[kk], desc_mn(dos, kk, col));
      wgmma_rs(dk, sa[kk], desc_mn(qs, kk, col));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();                             // the stage may be refilled
  }
  cp_async_wait<0>();

  // dK and dV through the K and V tiles' shared memory, for 16-byte stores
  stage_out(smem_raw, sK, dk, p.scale, r0, lane);
  if (has_v) stage_out(smem_raw, sV, dv, 1.f, r0, lane);
  __syncthreads();
  store_tile(p.dk + (b * Skv * KV + kvh) * kD + col * kCol, smem_raw, sK, k0,
             Skv, KV * kD, tid);
  if (has_v)
    store_tile(p.dv + (b * Skv * KV + kvh) * kDv + col * kCol, smem_raw, sV,
               k0, Skv, KV * kDv, tid);
}

// the two launches at head dims (kD, kDv), in one form: causal, windowed
// (kWin) or not, or non-causal.  A call without a window runs the code
// without its tests, a non-causal one the code without the diagonal's
template <int kD, int kDv, bool kWin, bool kCausal>
int run(const Params& p, cudaStream_t s) {
  constexpr int kCols = kD / kCol;
  constexpr int kDqSmem = dq_smem<kD, kDv>();
  constexpr int kDkdvSmem = dkdv_smem<kD, kDv>();
  cudaError_t e = cudaFuncSetAttribute(
      bwd_dq_sm90_kernel<kD, kDv, kWin, kCausal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(bwd_dkdv_sm90_kernel<kD, kDv, kWin, kCausal>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kDkdvSmem);
  if (e != cudaSuccess) return (int)e;
  bwd_dq_sm90_kernel<kD, kDv, kWin, kCausal>
      <<<(unsigned)(p.qtiles * p.B * p.H * kCols), kThreads, kDqSmem, s>>>(
          p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_dkdv_sm90_kernel<kD, kDv, kWin, kCausal>
      <<<(unsigned)(p.ktiles * p.B * p.KV * kCols), kThreads, kDkdvSmem,
         s>>>(p);
  return (int)cudaGetLastError();
}

// the forms built at (kD, kDv): causal with and without a window, and, where
// kNonCausal, non-causal ((64, 64) only: no other pair's model attends
// non-causally in training)
template <int kD, int kDv, bool kNonCausal>
int run_dims(const Params& p, bool win, bool causal, cudaStream_t s) {
  if (!causal) {
    if constexpr (kNonCausal) return run<kD, kDv, false, false>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  return win ? run<kD, kDv, true, true>(p, s) : run<kD, kDv, false, true>(p, s);
}

}  // namespace

extern "C" {

// The constants this library was built with: kThreads, kTile, and at (D,
// Dv) (64, 64), (128, 128), (192, 128) and (256, 256) the dQ and dK/dV
// kernels' stages and shared memory.  The wrapper refuses a library whose
// constants differ from its own.
void repro_flash_backward_sm90_constants(int* out) {
  out[0] = kThreads;
  out[1] = kTile;
  out[2] = Config<64, 64>::kDqStages;
  out[3] = Config<64, 64>::kDkdvStages;
  out[4] = dq_smem<64, 64>();
  out[5] = dkdv_smem<64, 64>();
  out[6] = Config<128, 128>::kDqStages;
  out[7] = Config<128, 128>::kDkdvStages;
  out[8] = dq_smem<128, 128>();
  out[9] = dkdv_smem<128, 128>();
  out[10] = Config<192, 128>::kDqStages;
  out[11] = Config<192, 128>::kDkdvStages;
  out[12] = dq_smem<192, 128>();
  out[13] = dkdv_smem<192, 128>();
  out[14] = Config<256, 256>::kDqStages;
  out[15] = Config<256, 256>::kDkdvStages;
  out[16] = dq_smem<256, 256>();
  out[17] = dkdv_smem<256, 256>();
}

// Launches the two kernels on `stream` (dQ, which writes the scratch, then
// dK/dV, which reads it) and returns cudaGetLastError() (0 when both
// launches were accepted).  Sizes are elements; window <= 0 means none;
// causal 0 means non-causal (then no window, (D, Dv) (64, 64)).  The
// wrapper has checked shapes (causal: Sq = Skv), dtypes (bf16),
// contiguity, 16-byte alignment and Sq, Skv > 0, and allocated dq, dk, dv
// and the f32 scratch lse and delta (B * H * Spad each, Spad = Sq rounded
// up to a multiple of 64).
int repro_flash_backward_sm90(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, void* dq,
                              void* dk, void* dv, void* lse, void* delta,
                              long long B, long long Sq, long long Skv,
                              long long H, long long KV, long long D,
                              long long Dv, long long window, int causal,
                              float scale, void* stream) {
  if (KV <= 0 || H % KV || (causal && Sq != Skv) ||
      (!causal && window >= 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.lse = static_cast<float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.B = B; p.Sq = Sq; p.Skv = Skv; p.H = H; p.KV = KV;
  p.qtiles = (Sq + kTile - 1) / kTile;
  p.ktiles = (Skv + kTile - 1) / kTile;
  p.Spad = p.qtiles * kTile;
  const bool win = causal && window >= 1 && window < Skv;  // a key is cut
  p.window = win ? window : Skv;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64 && Dv == 64) return run_dims<64, 64, true>(p, win, causal, s);
  if (D == 128 && Dv == 128)
    return run_dims<128, 128, false>(p, win, causal, s);
  if (D == 192 && Dv == 128)
    return run_dims<192, 128, false>(p, win, causal, s);
  if (D == 256 && Dv == 256)
    return run_dims<256, 256, false>(p, win, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
