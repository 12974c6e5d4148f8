// Flash attention for Hopper: out = softmax(q kᵀ / √d) v per (batch·head),
// under a causal and/or sliding-window mask, bf16 or f32 in, f32 inside.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _kernel), reached through
// repro/kernels/ops.py:flash_attention.  The TPU grid is (bh, q block,
// kv block) over the function's (bq, bk) = (min(128, sq), min(128, skv))
// blocks; the kv axis runs in order and carries m, l and acc in VMEM
// scratch, and a kv block out of the (causal, window) band is skipped
// whole.  Here one CTA owns a run of query rows of one bh and walks the
// kv axis itself in tiles, with m, l and acc in registers; the CTAs of
// one bh run its latest (longest, under a causal mask) rows first.
// What the function computes depends on the TPU's block grid (a row
// whose relevant block holds no unmasked key comes out as the mean of v
// over that block, because the -1e30 sentinel gives exp(0) = 1), so
// every (row, key) pair is classified on the FUNCTION's grid, whatever
// the CUDA tile:
//   its (bq, bk) block pair is not relevant -> absent  (-inf: p = 0)
//   relevant but masked                      -> -1e30   (the sentinel)
//   relevant and visible                     -> q·k * scale
// Online softmax as in the TPU body: m_new = max(m, rowmax), p = exp(s -
// m_new), l = l·corr + Σp, acc = acc·corr + p v, and out = 0 where l = 0.
// No atomics and a fixed summation order: two launches on the same input
// are bit-identical.
//
// Bound on an H100: operations.  Every visible (q, k) pair costs 4d
// flop (2d for q·k, 2d for p·v) against about 2·bh·(sq + skv)·d·bytes
// of traffic: at d = 128 over 4096 keys, several hundred flop per byte,
// above the card's 295 bf16 flop/byte (989 TFLOP/s on the tensor cores
// over 3.35 TB/s) and far above float32 FMA's 20 (67 TFLOP/s).
//
// bfloat16: flash_bf16_kernel, on the tensor cores (wgmma, TMA, mbarrier).
//   Split P.  The reference takes p and p·v in float32, and the card's
//   check holds the bf16 output within one bf16 ulp of that.  p rounded
//   once to bf16 breaks the check (tests/test_torch_attention.py emulates
//   this kernel's walk at bh 8, 1024 tokens, d 128, causal, and finds it
//   beyond the ulp), so p = hi + lo with hi = bf16(p) and lo = bf16(p -
//   hi), and hi·v + lo·v are both summed in the float32 O registers: the
//   tensor cores do 6d flop per pair, 1.5x the bound's 4d.  l sums the
//   float32 p, never hi.  The scale goes on the float32 scores after
//   Q Kᵀ (folding it into a bf16 Q would round Q), with log2(e) folded
//   into it: p = 2^(s·scale·log2e - m) on the SFU (ex2.approx), m kept in
//   the same base-2 units -- an error near 1e-7 of p, far inside a bf16
//   ulp, which the card's check confirms; the sentinel stays -1e30,
//   whose exp2 against any finite m is 0, as its exp is.
//   Tile.  A CTA of 256 threads, two consumer warpgroups, owns 128 query
//   rows of one bh; warpgroup w owns rows 64w .. 64w + 63 and holds their
//   S (64 floats a thread), hi and lo (32 registers each) and O (d/2
//   floats) in registers: 226 registers at d = 128, 188 at d = 64, and no
//   local memory (cuobjdump --dump-resource-usage on the card;
//   chip_smoke.py logs it).  Keys come in 128-key tiles.
//   Ring.  Q (128 x d) and a three-stage ring of K and V tiles live in
//   shared memory (230,464 bytes at d = 128), each as d/64 panels of
//   rows x 128 bytes with the 128-byte swizzle that the wgmma descriptors
//   read.  TMA fills them (a 3-d tensor map per operand; rows past the
//   sequence come as zeros, so keys >= skv are zero and absent); a full
//   mbarrier per stage counts the bytes in, an empty one counts all 256
//   threads out.  Thread 0 issues the copies, one tile ahead.
//   Roles.  No producer warp: the two warpgroups take turns on the tensor
//   cores (two named barriers).  Turn n of a warpgroup issues O += hi V +
//   lo V for tile n - 1 (wgmma m64n{d}k16, A from registers, V the B
//   operand MN-major through the transpose bit) and S = Q Kᵀ for tile n
//   (wgmma m64n128k16, A and B from shared memory, both K-major) as one
//   group, passes the turn, and waits for them; then it runs tile n's
//   scale, mask and online softmax (row max and Σ over the 4 lanes that
//   share a row) and packs hi and lo straight from the S registers into
//   wgmma's register A fragments, while the other warpgroup's products
//   run.
//   Tile kinds.  The tiles with any relevant pair are a run [t_begin,
//   t_end) (a causal mask keeps a prefix, a window a suffix); the rest
//   are skipped, as the TPU skips a block.  A tile of the run is *all
//   visible* when every key is below skv and every pair passes the
//   causal and window tests (a visible pair is always relevant): its
//   scores only take the scale.  Any other tile is *mixed*: each pair
//   gets the per-pair test on the function's grid.
//
// float32: flash_f32_kernel, on the tensor cores with 3xTF32.  TF32 alone
//   (a 10-bit mantissa) cannot hold the float32 check of rtol 1e-4 / atol
//   1e-5 (tests/test_torch_attention.py emulates this kernel's rounding
//   and finds 1xTF32 far beyond it), so every operand is split as x = hi
//   + lo, hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and each product
//   is lo·hi + hi·lo, then hi·hi, summed in float32 (lo·lo dropped): the
//   tensor cores do 3 x 4d flop per visible pair, 3 x 137.5 GFLOP at
//   causal 2048 (0.83 ms at 495 TFLOP/s), against 2.05 ms for float32 on
//   the FMA units at their 67 TFLOP/s peak.  P is split from the float32
//   p registers; l sums the float32 p; the scale goes on the float32
//   scores after Q Kᵀ, in base 2 as in the bfloat16 kernel.
//   Layout.  wgmma reads tf32 operands from shared memory K-major only
//   (its transpose bits exist for f16/bf16 alone).  Q and K are K-major
//   for S = Q Kᵀ as they lie; V is not, for O += P V.  Split passes run
//   before the kernel, once per call: flash_split_k_kernel writes K hi and
//   lo in K's layout, flash_split_vt_kernel writes Vᵀ hi and lo (bh, d,
//   keys), so TMA feeds every K and V tile already split and V arrives
//   K-major -- rather than re-splitting each tile in every CTA of a bh
//   (32 CTAs each at 2048 tokens) or moving P V to mma.sync.  Vᵀ's keys
//   are permuted within groups of 8 (position t holds key 2t, t + 4 key
//   2t + 1), which is where the S accumulator leaves each thread's p in
//   the tf32 A fragment.  Q is split once per CTA and stored in the
//   128-byte swizzle by the threads themselves.
//   Tile.  A CTA of one warpgroup (128 threads) owns 64 query rows and
//   walks 32-key tiles.  Q hi lives in registers as the A fragments of
//   the two hi products (64 registers at d = 128), which halves the
//   shared-memory reads of S = Q Kᵀ's narrow m64n32k8 wgmmas; Q lo (32
//   KB), one K slot and one V slot (hi and lo, 32 KB each) fill 99,360
//   bytes, so two CTAs share an SM and one's softmax runs beside the
//   other's products.  Per tile: Q Kᵀ (Q lo·K hi from shared memory, then
//   Q hi·K lo and Q hi·K hi from registers), K's slot released and
//   refilled by TMA for the next tile; the softmax; P V (m64n{d}k8, P
//   from registers), V's slot released and refilled.  The tile kinds
//   (skipped, all visible, mixed) are the bfloat16 kernel's.  No
//   atomics: launches are bit-identical.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

#define SENTINEL (-1e30f)  // the TPU kernel's NEG_INF

struct Band {            // the function's block grid and masks
  int fq, fk, causal, has_window, window;
  // is the (q block of row r, kv block of key c) pair computed at all?
  __device__ __forceinline__ bool relevant(int r, int c) const {
    const int q_lo = (r / fq) * fq, k_lo = (c / fk) * fk;
    bool rel = true;
    if (causal) rel = k_lo <= q_lo + fq - 1;
    if (has_window) rel = rel && k_lo + fk - 1 >= q_lo - window + 1;
    return rel;
  }
  __device__ __forceinline__ bool visible(int r, int c) const {
    return (!causal || r >= c) && (!has_window || r - c < window);
  }
};

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 128;    // query rows per CTA: two warpgroups of 64
constexpr int BK = 128;    // keys per tile
constexpr int NT = 256;    // threads per CTA
constexpr int ST = 3;      // stages of the K/V ring
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival on bar that also expects `bytes` more of transfers
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait for the phase of bar with this parity to complete.  A phase that
// never completes traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// turns on the tensor cores: named barriers 1 and 2 (0 is
// __syncthreads'), each synced by one warpgroup and arrived at by the other
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// TMA: the box at (c0, c1, c2) of a 3-d tensor map into shared memory,
// completing its bytes on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of r across an asm statement
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units, layout type 1 (B128)
// in bits 62-63.  K-major operands (Q, K) step 8-row groups by the stride
// (1024 bytes); MN-major V steps its 64-column panels by the leading
// offset and 8-key groups by the stride.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// wgmma bf16 -> f32, m64nNk16 with N/2 accumulators a thread: S = Q Kᵀ
// (N = 128 keys; A and B from shared memory, both K-major; acc = 0 makes
// D = A·B) and O += P V (N = d; A from registers, B MN-major).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the SFU; subnormal results flush to 0 (a p below 2^-126 is
// beyond anything a bf16 output keeps)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// S = Q Kᵀ for one warpgroup: its 64 Q rows (from sQw) against the K tile
// at sK, over d in steps of 16 (32 bytes along a swizzled panel row)
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t sQw,
                                         uint32_t sK) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t qa = sQw + (ks >> 2) * (BQ * 128) + (ks & 3) * 32;
    const uint32_t ka = sK + (ks >> 2) * (BK * 128) + (ks & 3) * 32;
    wgmma_ss(s, sw128_desc(qa, 16, 1024), sw128_desc(ka, 16, 1024), ks > 0);
  }
}

// O += hi V + lo V over the V tile at sV, in steps of 16 keys (2048 bytes)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&ph)[BK / 16][4],
                                         uint32_t (&pl)[BK / 16][4],
                                         uint32_t sV) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = sw128_desc(sV + kk * 2048, BK * 128, 1024);
    wgmma_rs(acc, ph[kk], dv);
    wgmma_rs(acc, pl[kk], dv);
  }
}

// The scores s of the tile at key c0 for this thread's rows ra and ra + 8
// (columns 8j + cl + {0, 1} of each 8-column chunk j): scale and mask them,
// fold them into the online softmax (m, l, acc), and split p into the
// hi and lo A fragments of P V.  q_hi and q_wlo hold each row's bounds on
// the function's grid: a pair is relevant when its k_lo <= q_hi (causal)
// and k_lo + fk - 1 >= q_wlo (window).
template <int D>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&acc)[D / 2], uint32_t (&ph)[BK / 16][4],
    uint32_t (&pl)[BK / 16][4], float (&m)[2], float (&l)[2],
    const Band& band, int c0, int skv, int r_lo, int r_hi, int ra, int cl,
    const int (&q_hi)[2], const int (&q_wlo)[2], float scale_log2) {
  const bool all_visible = c0 + BK <= skv &&
                           (!band.causal || r_lo >= c0 + BK - 1) &&
                           (!band.has_window || r_hi - c0 < band.window);
  // an all-visible tile keeps q·k and takes the scale inside the
  // exponent's FMA below; a mixed tile's scores are scaled here
  const float sc = all_visible ? scale_log2 : 1.f;
  if (!all_visible) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + cl + e, k_lo = c - c % band.fk;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = ra + 8 * i;
          const bool rel = c < skv && (!band.causal || k_lo <= q_hi[i]) &&
                           (!band.has_window || k_lo + band.fk - 1 >= q_wlo[i]);
          float& x = s[4 * j + 2 * i + e];
          x = !rel ? -INFINITY : band.visible(r, c) ? x * scale_log2 : SENTINEL;
        }
      }
  }

  // online softmax on the thread's two rows; a row's 4 lanes are
  // lane ^ 1 and lane ^ 2.  l stays a per-thread partial until the end.
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * sc);   // sc > 0: max commutes
    corr[i] = ex2(m[i] - m_new);
    m[i] = m_new;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = ex2(fmaf(x, sc, -m_new));
        ps += x;
      }
    l[i] = l[i] * corr[i] + ps;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= corr[0]; acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1]; acc[4 * j + 3] *= corr[1];
  }

  // P = hi + lo in bf16, as wgmma's register A fragments: for keys
  // 16kk .. 16kk + 15, register 2h + i holds row i's pair of chunk 2kk + h
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int x = 4 * (2 * kk + h) + 2 * i;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(s[x], s[x + 1]);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][2 * h + i] = bf16x2_bits(hi);
        pl[kk][2 * h + i] =
            bf16x2_bits(__floats2bfloat162_rn(s[x] - hf.x, s[x + 1] - hf.y));
      }

}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, int sq, int skv,
                  int n_qtiles, Band band, float scale_log2) {
  constexpr int QB = BQ * D * 2;         // bytes of the Q tile
  constexpr int KB = BK * D * 2;         // bytes of one K or V tile
  extern __shared__ unsigned char smem_raw[];
  // swizzle atoms are 1024 bytes and must start 1024-aligned
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sKV = sQ + QB;          // stage s: K at +2s·KB, V after it

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  // longest rows (latest q tiles under a causal mask) are scheduled first
  const int bh = blockIdx.x / n_qtiles;
  const int r0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * BQ;

  // the run of tiles holding a relevant pair (uniform over the CTA): the
  // causal test is loosest at (last row, first key), the window's at
  // (first row, last key)
  const int r_lo = r0, r_hi = min(r0 + BQ, sq) - 1;
  int t_begin = 0, t_end = (skv + BK - 1) / BK;
  if (band.causal)
    while (t_end > 0 &&
           !Band{band.fq, band.fk, 1, 0, 0}.relevant(r_hi, (t_end - 1) * BK))
      --t_end;
  if (band.has_window)
    while (t_begin < t_end &&
           !Band{band.fq, band.fk, 0, 1, band.window}.relevant(
               r_lo, min((t_begin + 1) * BK, skv) - 1))
      ++t_begin;

  // this thread's rows ra and ra + 8, and columns 8j + cl + {0, 1} of
  // every 8-column chunk j of S and O (the wgmma accumulator layout)
  const int ra = r0 + wg * 64 + warp * 16 + (lane >> 2);
  const int cl = 2 * (lane & 3);
  int q_hi[2], q_wlo[2];                 // per row: k_lo <= q_hi (causal),
#pragma unroll                           // k_lo + fk - 1 >= q_wlo (window)
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i, q_lo = r - r % band.fq;
    q_hi[i] = q_lo + band.fq - 1;
    q_wlo[i] = q_lo - band.window + 1;
  }

  float m[2] = {SENTINEL, SENTINEL}, l[2] = {0.f, 0.f};
  float acc[D / 2], s[BK / 2];
  uint32_t ph[BK / 16][4], pl[BK / 16][4];   // P = hi + lo of the last tile
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // the ring: ST stages, each K then V, filled by TMA (128-row boxes of
  // one 64-column panel, swizzled as the descriptors read them; rows past
  // the sequence come as zeros).  full[i] completes when stage i's bytes
  // have landed, empty[i] when all 256 threads are done reading it.
  // Thread 0 issues the copies.
  const uint32_t sBar = sKV + ST * 2 * KB;
  const auto full = [&](int i) { return sBar + 8 * i; };
  const auto empty = [&](int i) { return sBar + 8 * (ST + i); };
  const int n_tiles = t_end - t_begin;
  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const auto fill = [&](int n) {         // tile n of the run (Q with the first)
    const int i = n % ST, row0 = (t_begin + n) * BK;
    const uint32_t dst = sKV + 2 * i * KB;
    if (n >= ST) mbar_wait(empty(i), (n / ST - 1) & 1);
    mbar_expect_tx(full(i), 2 * KB + (n == 0 ? QB : 0));
#pragma unroll
    for (int p = 0; p < D / 64; ++p) {
      if (n == 0) tma_load(sQ + p * (BQ * 128), &tq, full(i), 64 * p, r0, bh);
      tma_load(dst + p * (BK * 128), &tk, full(i), 64 * p, row0, bh);
      tma_load(dst + KB + p * (BK * 128), &tv, full(i), 64 * p, row0, bh);
    }
  };

  // Turn n of a warpgroup issues P V of tile n - 1 and Q Kᵀ of tile n to
  // the tensor cores; between turns it runs tile n's softmax while the
  // other warpgroup takes its turn.  Warpgroup 0 goes first, and its
  // thread 0 fills the ring one tile ahead: after its turn n, into the
  // stage of tile n - 2, which both warpgroups release as their turn
  // n - 1 completes, before this turn's products do.
  const uint32_t sQw = sQ + wg * (64 * 128);
  const auto stage = [&](int n) { return sKV + 2 * (n % ST) * KB; };
  if (n_tiles > 0) {
    if (tid == 0) fill(0);
    if (wg == 1) turn_pass(1);
    turn_wait(1 + wg);
    mbar_wait(full(0), 0);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    reg_fence(s);
    wgmma_fence();
    issue_qk<D>(s, sQw, stage(0));
    wgmma_commit();
    turn_pass(2 - wg);
    if (tid == 0 && n_tiles > 1) fill(1);
    wgmma_wait();
    reg_fence(s);
    softmax_tile<D>(s, acc, ph, pl, m, l, band, t_begin * BK, skv, r_lo, r_hi,
                    ra, cl, q_hi, q_wlo, scale_log2);
  }
  for (int n = 1; n < n_tiles; ++n) {
    turn_wait(1 + wg);
    mbar_wait(full(n % ST), (n / ST) & 1);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;   // (dead before Q Kᵀ)
    reg_fence(acc);
    reg_fence(s);
    wgmma_fence();
    issue_pv<D>(acc, ph, pl, stage(n - 1) + KB);
    issue_qk<D>(s, sQw, stage(n));
    wgmma_commit();
    turn_pass(2 - wg);
    if (tid == 0 && n + 1 < n_tiles) fill(n + 1);
    wgmma_wait();
    reg_fence(acc);
    reg_fence(s);
    mbar_arrive(empty((n - 1) % ST));
    softmax_tile<D>(s, acc, ph, pl, m, l, band, (t_begin + n) * BK, skv, r_lo,
                    r_hi, ra, cl, q_hi, q_wlo, scale_log2);
  }
  if (n_tiles > 0) {                     // the last turn: P V of the last tile
    turn_wait(1 + wg);
    reg_fence(acc);
    wgmma_fence();
    issue_pv<D>(acc, ph, pl, stage(n_tiles - 1) + KB);
    wgmma_commit();
    if (wg == 0) turn_pass(2);
    wgmma_wait();
    reg_fence(acc);
  }

  __nv_bfloat16* ob = o + (long long)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (r >= sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a = acc[4 * j + 2 * i], b = acc[4 * j + 2 * i + 1];
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r * D + 8 * j + cl) =
          l[i] != 0.f ? __floats2bfloat162_rn(a / l[i], b / l[i])
                      : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

// The driver's tensor-map encoder, reached through the runtime (no link
// to libcuda); null if the driver lacks it.
static PFN_cuTensorMapEncodeTiled_v12000 encoder() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// (bh, n, d) bf16 as a 3-d tensor map whose box is one 64-column panel of
// `rows` rows, 128-byte swizzled; reads past n give zeros
static bool tensor_map(CUtensorMap* map, const void* base, int bh, int n,
                       int d, int rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)bh};
  cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)n * d * 2};
  cuuint32_t box[3] = {64, (cuuint32_t)rows, 1}, step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int bh, int sq, int skv, Band band, float scale,
                  cudaStream_t stream) {
  // Q, the ring's ST stages of K and V and its 2·ST mbarriers, and room
  // to align the start to 1024 bytes: 230,464 bytes at d = 128
  constexpr int SMEM = BQ * D * 2 + ST * 2 * BK * D * 2 + 16 * ST + 1024;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, bh, sq, D, BQ) || !tensor_map(&tk, k, bh, skv, D, BK) ||
      !tensor_map(&tv, v, bh, skv, D, BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  const long long ctas = (long long)n_qtiles * bh;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bf16_kernel<D><<<(unsigned)ctas, NT, SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, sq, skv, n_qtiles, band, scale * LOG2E);
  return last_error();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;     // query rows per CTA: one warpgroup
constexpr int BK = 32;     // keys per tile
constexpr int NT = 128;    // threads per CTA
using tc::smem_u32;

// x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), each rounded to
// nearest, ties away (cvt.rna), as tf32 bits in a float container
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// The split pass over K: hi and lo in K's own layout (bh, skv, d), which
// is K-major for S = Q Kᵀ.  n4: float4s in K.
__global__ void flash_split_k_kernel(const float4* __restrict__ k,
                                     uint4* __restrict__ hi,
                                     uint4* __restrict__ lo, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 x = __ldg(k + i);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    hi[i] = h;
    lo[i] = l;
  }
}

// position p of every 8-key group of Vᵀ holds key perm(p) of the group:
// the S accumulator gives a thread keys 2t and 2t + 1 of each 8-key chunk,
// and the tf32 A fragment wants them in columns t and t + 4
__device__ __forceinline__ int perm(int p) { return p < 4 ? 2 * p : 2 * p - 7; }

// The split pass over V: hi and lo of Vᵀ (bh, d, skvp), keys contiguous
// (K-major for O += P V) and permuted within groups of 8; keys in [skv,
// skvp) are 0.  A 32 x 8 block moves a 32-key x 32-column tile; the grid
// is (bh, d / 32, key tiles).
__global__ void flash_split_vt_kernel(const float* __restrict__ v,
                                      uint32_t* __restrict__ hi,
                                      uint32_t* __restrict__ lo, int skv,
                                      int skvp, int d) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = blockIdx.z * 32, d0 = blockIdx.y * 32;
  const long long bh = blockIdx.x;
  const float* vb = v + bh * skv * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 8 * i;
    tile[ty + 8 * i][tx] = key < skv ? __ldg(vb + (long long)key * d + d0 + tx) : 0.f;
  }
  __syncthreads();
  const int key = (tx & ~7) + perm(tx & 7);
  if (k0 + tx >= skvp) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long at = (bh * d + d0 + ty + 8 * i) * skvp + k0 + tx;
    uint32_t h, l;
    split(tile[key][ty + 8 * i], h, l);
    hi[at] = h;
    lo[at] = l;
  }
}

// wgmma tf32 -> f32, K-major operands only (tf32 has no transpose bits):
// S = Q Kᵀ (m64n32k8, A and B from shared memory; acc = 0 makes D = A·B)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// S += Q_hi Kᵀ (m64n32k8, A = Q hi from registers)
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V (m64n{d}k8, A = P from registers, B = Vᵀ from shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q Kᵀ for the warpgroup's 64 rows against the K tile at sK (hi, then
// lo KB bytes on), over d in steps of 8 (32 bytes along a swizzled panel
// row of 32 floats): the small products lo·hi (Q lo from shared memory)
// and hi·lo (Q hi from registers) first, then hi·hi
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2],
                                         const uint32_t (&qh)[D / 8][4],
                                         uint32_t sQl, uint32_t sK) {
  constexpr int KB = BK * D * 4;
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const uint32_t qa = sQl + (ks >> 2) * (BQ * 128) + (ks & 3) * 32;
    const uint32_t ka = sK + (ks >> 2) * (BK * 128) + (ks & 3) * 32;
    wgmma_ss(s, tc::sw128_desc(qa, 16, 1024), tc::sw128_desc(ka, 16, 1024), ks > 0);
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const uint32_t ka = sK + (ks >> 2) * (BK * 128) + (ks & 3) * 32;
    wgmma_rs(s, qh[ks], tc::sw128_desc(ka + KB, 16, 1024));
  }
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const uint32_t ka = sK + (ks >> 2) * (BK * 128) + (ks & 3) * 32;
    wgmma_rs(s, qh[ks], tc::sw128_desc(ka, 16, 1024));
  }
}

// O += P V over the Vᵀ tile at sVh (hi; lo KB bytes on), one panel of 32
// keys x d rows, in steps of 8 keys (32 bytes): lo·hi and hi·lo, then hi·hi
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&ph)[BK / 8][4],
                                         const uint32_t (&pl)[BK / 8][4],
                                         uint32_t sVh) {
  constexpr int KB = BK * D * 4;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    wgmma_rs(acc, pl[kk], tc::sw128_desc(sVh + kk * 32, 16, 1024));
    wgmma_rs(acc, ph[kk], tc::sw128_desc(sVh + KB + kk * 32, 16, 1024));
  }
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    wgmma_rs(acc, ph[kk], tc::sw128_desc(sVh + kk * 32, 16, 1024));
}

// The scores s of the tile at key c0 (this thread's rows ra and ra + 8,
// keys 8j + cl + {0, 1}): scale, mask and fold them into the online
// softmax, as the bfloat16 kernel does, and split p into the tf32 hi and
// lo A fragments of P V -- register 0 row ra key 2t, 1 row ra + 8 key 2t,
// 2 row ra key 2t + 1, 3 row ra + 8 key 2t + 1 of each 8-key chunk, which
// Vᵀ's permuted groups match.
template <int D>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&acc)[D / 2], uint32_t (&ph)[BK / 8][4],
    uint32_t (&pl)[BK / 8][4], float (&m)[2], float (&l)[2],
    const Band& band, int c0, int skv, int r_lo, int r_hi, int ra, int cl,
    const int (&q_hi)[2], const int (&q_wlo)[2], float scale_log2) {
  const bool all_visible = c0 + BK <= skv &&
                           (!band.causal || r_lo >= c0 + BK - 1) &&
                           (!band.has_window || r_hi - c0 < band.window);
  const float sc = all_visible ? scale_log2 : 1.f;
  if (!all_visible) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + cl + e, k_lo = c - c % band.fk;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = ra + 8 * i;
          const bool rel = c < skv && (!band.causal || k_lo <= q_hi[i]) &&
                           (!band.has_window || k_lo + band.fk - 1 >= q_wlo[i]);
          float& x = s[4 * j + 2 * i + e];
          x = !rel ? -INFINITY : band.visible(r, c) ? x * scale_log2 : SENTINEL;
        }
      }
  }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx * sc);
    corr[i] = tc::ex2(m[i] - m_new);
    m[i] = m_new;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * i + e];
        x = tc::ex2(fmaf(x, sc, -m_new));
        ps += x;
      }
    l[i] = l[i] * corr[i] + ps;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= corr[0]; acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1]; acc[4 * j + 3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    split(s[4 * kk], ph[kk][0], pl[kk][0]);
    split(s[4 * kk + 2], ph[kk][1], pl[kk][1]);
    split(s[4 * kk + 1], ph[kk][2], pl[kk][2]);
    split(s[4 * kk + 3], ph[kk][3], pl[kk][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_f32_kernel(const __grid_constant__ CUtensorMap tkh,
                 const __grid_constant__ CUtensorMap tkl,
                 const __grid_constant__ CUtensorMap tvh,
                 const __grid_constant__ CUtensorMap tvl,
                 const float* __restrict__ q, float* __restrict__ o, int sq,
                 int skv, int n_qtiles, Band band, float scale_log2) {
  constexpr int QB = BQ * D * 4;         // bytes of Q lo
  constexpr int KB = BK * D * 4;         // bytes of one tile's K hi, K lo, Vᵀ hi or Vᵀ lo
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQl = (raw + 1023) & ~1023u;   // swizzle atoms: 1024-aligned
  const uint32_t sK = sQl + QB;          // K hi, K lo of the current tile
  const uint32_t sV = sK + 2 * KB;       // Vᵀ hi, Vᵀ lo of the current tile
  const uint32_t sBar = sV + 2 * KB;     // full K, empty K, full V, empty V

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // longest rows (latest q tiles under a causal mask) are scheduled first
  const int bh = blockIdx.x / n_qtiles;
  const int r0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * BQ;

  const int r_lo = r0, r_hi = min(r0 + BQ, sq) - 1;
  int t_begin = 0, t_end = (skv + BK - 1) / BK;
  if (band.causal)
    while (t_end > 0 &&
           !Band{band.fq, band.fk, 1, 0, 0}.relevant(r_hi, (t_end - 1) * BK))
      --t_end;
  if (band.has_window)
    while (t_begin < t_end &&
           !Band{band.fq, band.fk, 0, 1, band.window}.relevant(
               r_lo, min((t_begin + 1) * BK, skv) - 1))
      ++t_begin;
  const int n_tiles = t_end - t_begin;

  const int ra = r0 + warp * 16 + (lane >> 2);
  const int cl = 2 * (lane & 3);
  int q_hi[2], q_wlo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i, q_lo = r - r % band.fq;
    q_hi[i] = q_lo + band.fq - 1;
    q_wlo[i] = q_lo - band.window + 1;
  }

  // one K slot and one V slot, each with a full barrier (its bytes have
  // landed) and an empty one (all 128 threads are done with it); thread 0
  // refills K as soon as Q Kᵀ has read it and V as soon as P V has, so
  // each copy runs behind the other half of the tile (and the other CTA
  // on the SM)
  const uint32_t fullK = sBar, emptyK = sBar + 8, fullV = sBar + 16,
                 emptyV = sBar + 24;
  if (tid == 0) {
    tc::mbar_init(fullK, 1);
    tc::mbar_init(emptyK, NT);
    tc::mbar_init(fullV, 1);
    tc::mbar_init(emptyV, NT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const auto fill_k = [&](int n) {
    const int row0 = (t_begin + n) * BK;
    tc::mbar_expect_tx(fullK, 2 * KB);
#pragma unroll
    for (int p = 0; p < D / 32; ++p) {
      tc::tma_load(sK + p * (BK * 128), &tkh, fullK, 32 * p, row0, bh);
      tc::tma_load(sK + KB + p * (BK * 128), &tkl, fullK, 32 * p, row0, bh);
    }
  };
  const auto fill_v = [&](int n) {
    const int row0 = (t_begin + n) * BK;
    tc::mbar_expect_tx(fullV, 2 * KB);
    tc::tma_load(sV, &tvh, fullV, row0, 0, bh);
    tc::tma_load(sV + KB, &tvl, fullV, row0, 0, bh);
  };
  if (tid == 0 && n_tiles > 0) {
    fill_k(0);
    fill_v(0);
  }

  // Q: hi as this thread's tf32 A fragments (rows ra, ra + 8; columns
  // 8ks + t and 8ks + t + 4 of each 8-column step ks), lo in shared
  // memory as the 128-byte swizzle lays it out: panel c4 / 8 (32
  // columns), row r at 128 r, its 16-byte chunk c4 % 8 at chunk
  // (c4 % 8) ^ (r % 8)
  const float* qb = q + ((long long)bh * sq + r0) * D;
  uint32_t qh[D / 8][4];
  {
    const int rr = ra - r0, t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rr + 8 * (e & 1), c = 8 * ks + t + 4 * (e >> 1);
        qh[ks][e] = r0 + r < sq ? tf32(__ldg(qb + (long long)r * D + c)) : 0u;
      }
    unsigned char* gQl = smem_raw + (sQl - raw);
    for (int e = tid; e < BQ * D / 4; e += NT) {
      const int r = e / (D / 4), c4 = e % (D / 4);
      const float4 x = r0 + r < sq
          ? __ldg(reinterpret_cast<const float4*>(qb + (long long)r * D) + c4)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      uint4 h, lo;
      split(x.x, h.x, lo.x);
      split(x.y, h.y, lo.y);
      split(x.z, h.z, lo.z);
      split(x.w, h.w, lo.w);
      const int off = (c4 >> 3) * (BQ * 128) + r * 128 + (((c4 & 7) ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(gQl + off) = lo;
    }
    // the generic-proxy stores must be visible to wgmma's async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  float m[2] = {SENTINEL, SENTINEL}, l[2] = {0.f, 0.f};
  float acc[D / 2], s[BK / 2];
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int n = 0; n < n_tiles; ++n) {
    const bool more = n + 1 < n_tiles;
    tc::mbar_wait(fullK, n & 1);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    tc::reg_fence(s);
    tc::wgmma_fence();
    issue_qk<D>(s, qh, sQl, sK);
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::reg_fence(s);
    tc::mbar_arrive(emptyK);
    if (tid == 0 && more) {
      tc::mbar_wait(emptyK, n & 1);
      fill_k(n + 1);
    }
    softmax_tile<D>(s, acc, ph, pl, m, l, band, (t_begin + n) * BK, skv, r_lo,
                    r_hi, ra, cl, q_hi, q_wlo, scale_log2);
    tc::mbar_wait(fullV, n & 1);
    tc::reg_fence(acc);
    tc::wgmma_fence();
    issue_pv<D>(acc, ph, pl, sV);
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::reg_fence(acc);
    tc::mbar_arrive(emptyV);
    if (tid == 0 && more) {
      tc::mbar_wait(emptyV, n & 1);
      fill_v(n + 1);
    }
  }

  float* ob = o + (long long)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (r >= sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a = acc[4 * j + 2 * i], b = acc[4 * j + 2 * i + 1];
      *reinterpret_cast<float2*>(ob + (long long)r * D + 8 * j + cl) =
          l[i] != 0.f ? make_float2(a / l[i], b / l[i]) : make_float2(0.f, 0.f);
    }
  }
}

// (outer, rows, inner) float32 as a 3-d tensor map whose box is 32 inner
// values (128 bytes, swizzled) x box_rows rows; reads past the ends give
// zeros
static bool tensor_map(CUtensorMap* map, const void* base, int outer,
                       int rows, int inner, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tc::encoder();
  if (encode == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)outer};
  cuuint64_t strides[2] = {(cuuint64_t)inner * 4, (cuuint64_t)rows * inner * 4};
  cuuint32_t box[3] = {32, (cuuint32_t)box_rows, 1}, step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// floats of the split workspace: K hi and lo (bh, skv, d), Vᵀ hi and lo
// (bh, d, skvp) with skvp = skv rounded up to 8
static long long workspace_floats(int bh, int skv, int d) {
  const long long skvp = (skv + 7) / 8 * 8;
  return 2LL * bh * d * (skv + skvp);
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int bh, int sq, int skv, Band band, float scale,
                  float* ws, long long ws_floats, cudaStream_t stream) {
  // Q lo, one K and one V tile (hi and lo each), four mbarriers and room
  // to align the start to 1024 bytes: 99,360 bytes at d = 128, so two
  // CTAs share an SM
  constexpr int SMEM = BQ * D * 4 + 4 * BK * D * 4 + 32 + 1024;
  if (ws == nullptr || ws_floats < workspace_floats(bh, skv, D))
    return (int)cudaErrorInvalidValue;
  const int skvp = (skv + 7) / 8 * 8;
  const long long nk = (long long)bh * skv * D;
  float* kh = ws;
  float* kl = kh + nk;
  float* vh = kl + nk;
  float* vl = vh + (long long)bh * D * skvp;
  const long long n4 = nk / 4;
  const long long blocks4 = (n4 + 255) / 256;
  const unsigned split_ctas = (unsigned)(blocks4 < 132 * 16 ? blocks4 : 132 * 16);
  flash_split_k_kernel<<<split_ctas, 256, 0, stream>>>(
      (const float4*)k, (uint4*)kh, (uint4*)kl, n4);
  if ((skvp + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
  flash_split_vt_kernel<<<dim3(bh, D / 32, (skvp + 31) / 32), dim3(32, 8), 0, stream>>>(
      (const float*)v, (uint32_t*)vh, (uint32_t*)vl, skv, skvp, D);
  int e = last_error();
  if (e != 0) return e;
  CUtensorMap tkh, tkl, tvh, tvl;
  if (!tensor_map(&tkh, kh, bh, skv, D, BK) || !tensor_map(&tkl, kl, bh, skv, D, BK) ||
      !tensor_map(&tvh, vh, bh, D, skvp, D) || !tensor_map(&tvl, vl, bh, D, skvp, D))
    return (int)cudaErrorInvalidValue;
  cudaError_t a = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (a != cudaSuccess) return (int)a;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  const long long ctas = (long long)n_qtiles * bh;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_f32_kernel<D><<<(unsigned)ctas, NT, SMEM, stream>>>(
      tkh, tkl, tvh, tvl, (const float*)q, (float*)o, sq, skv, n_qtiles, band,
      scale * tc::LOG2E);
  return last_error();
}

}  // namespace f32

// dtype: 0 float32, 1 bfloat16.  d in {64, 128}.  fq, fk: the function's
// (bq, bk) blocks, dividing sq and skv.  window is read when has_window.
// ws: float32's split workspace of ws_floats floats (f32::workspace_floats;
// bfloat16 takes none).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int bh, int sq, int skv, int d,
                                   int fq, int fk, int causal, int has_window,
                                   int window, float scale, int dtype,
                                   void* ws, long long ws_floats,
                                   void* stream) {
  if (bh == 0 || sq == 0) return 0;
  if (fq < 1 || fk < 1 || skv < 1) return (int)cudaErrorInvalidValue;
  const Band band{fq, fk, causal, has_window, window};
  cudaStream_t s = (cudaStream_t)stream;
  float* w = (float*)ws;
  if (dtype == 0 && d == 64) return f32::launch<64>(q, k, v, o, bh, sq, skv, band, scale, w, ws_floats, s);
  if (dtype == 0 && d == 128) return f32::launch<128>(q, k, v, o, bh, sq, skv, band, scale, w, ws_floats, s);
  if (dtype == 1 && d == 64) return tc::launch<64>(q, k, v, o, bh, sq, skv, band, scale, s);
  if (dtype == 1 && d == 128) return tc::launch<128>(q, k, v, o, bh, sq, skv, band, scale, s);
  return (int)cudaErrorInvalidValue;
}
