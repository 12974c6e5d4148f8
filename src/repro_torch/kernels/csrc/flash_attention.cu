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
// float32: flash_f32_kernel, the first design, on the FMA units (TF32's
//   10-bit mantissa cannot hold rtol 1e-4).  One CTA of 256 threads owns
//   64 query rows and walks 64-key tiles; K and V are staged in shared
//   memory, each thread computes a 4 x 4 block of scores with float4
//   shared-memory reads and FMAs, the row max and sum go through a
//   16-lane xor butterfly, P overwrites K's buffer, and each thread
//   accumulates 4 rows x d/16 columns of P V.  About 100 KB of shared
//   memory at d = 128, so two CTAs share an SM.
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
// float32: the FMA kernel
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;     // query rows per CTA
constexpr int BK = 64;     // keys per tile
constexpr int NT = 256;    // threads per CTA: 16 row groups x 16 lanes

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// Σ / max over the 16 lanes that share a row group (lane bit 4 = group)
__device__ __forceinline__ float group_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int sq, int skv,
                 int n_qtiles, Band band, float scale) {
  constexpr int QS = D + 4;        // row stride of Q and K (float4, no conflicts)
  constexpr int PS = BK + 4;       // row stride of P
  constexpr int CG = D / 64;       // float4 column groups per thread
  constexpr int KP = (BK * QS > BQ * PS) ? BK * QS : BQ * PS;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KPs = Qs + BQ * QS;       // K tile, then P over it
  float* Vs = KPs + KP;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // longest rows (latest q tiles under a causal mask) are scheduled first
  const int bh = blockIdx.x / n_qtiles;
  const int r0 = (n_qtiles - 1 - blockIdx.x % n_qtiles) * BQ;
  const float* qb = q + (long long)bh * sq * D;
  const float* kb = k + (long long)bh * skv * D;
  const float* vb = v + (long long)bh * skv * D;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int e = tid; e < BQ * D / 4; e += NT) {
    const int r = e / (D / 4), c = (e % (D / 4)) * 4;
    store4(Qs + r * QS + c,
           r0 + r < sq ? load4(qb + (long long)(r0 + r) * D + c) : zero);
  }

  float m[4], l[4];
  float4 acc[4][CG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = SENTINEL;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < CG; ++g) acc[i][g] = zero;
  }

  const int r_lo = r0, r_hi = min(r0 + BQ, sq) - 1;
  const int n_ktiles = (skv + BK - 1) / BK;
  for (int t = 0; t < n_ktiles; ++t) {
    const int c0 = t * BK, c_hi = min(c0 + BK, skv) - 1;
    // skip a tile no pair of which is relevant (uniform over the CTA):
    // the causal test is loosest at (last row, first key), the window's
    // at (first row, last key)
    if (band.causal && !Band{band.fq, band.fk, 1, 0, 0}.relevant(r_hi, c0))
      continue;
    if (band.has_window && !Band{band.fq, band.fk, 0, 1, band.window}.relevant(r_lo, c_hi))
      continue;

    __syncthreads();               // the last tile's P and V are consumed
    for (int e = tid; e < BK * D / 4; e += NT) {
      const int r = e / (D / 4), c = (e % (D / 4)) * 4;
      const bool in = c0 + r < skv;
      store4(KPs + r * QS + c, in ? load4(kb + (long long)(c0 + r) * D + c) : zero);
      store4(Vs + r * D + c, in ? load4(vb + (long long)(c0 + r) * D + c) : zero);
    }
    __syncthreads();

    // scores: rows 4ty + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * QS + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(KPs + (tx + 16 * j) * QS + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        s[i][j] = (c >= skv || !band.relevant(r, c)) ? -INFINITY
                  : band.visible(r, c)               ? s[i][j] * scale
                                                     : SENTINEL;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + group_sum(ps);
      m[i] = m_new;
    }

    __syncthreads();               // every thread is done reading K
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) KPs[(4 * ty + i) * PS + tx + 16 * j] = s[i][j];
    __syncthreads();

    // acc = acc·corr + P V; columns 64 g + 4 tx .. + 3
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        acc[i][g].x *= corr[i]; acc[i][g].y *= corr[i];
        acc[i][g].z *= corr[i]; acc[i][g].w *= corr[i];
      }
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(KPs + (4 * ty + i) * PS + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float4 w = *reinterpret_cast<const float4*>(Vs + (kk + u) * D + 64 * g + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pu = u == 0 ? p[i].x : u == 1 ? p[i].y : u == 2 ? p[i].z : p[i].w;
            acc[i][g].x = fmaf(pu, w.x, acc[i][g].x);
            acc[i][g].y = fmaf(pu, w.y, acc[i][g].y);
            acc[i][g].z = fmaf(pu, w.z, acc[i][g].z);
            acc[i][g].w = fmaf(pu, w.w, acc[i][g].w);
          }
        }
      }
    }
  }

  float* ob = o + (long long)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * ty + i;
    if (r >= sq) continue;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      float4 y = zero;
      if (l[i] != 0.f)
        y = make_float4(acc[i][g].x / l[i], acc[i][g].y / l[i],
                        acc[i][g].z / l[i], acc[i][g].w / l[i]);
      store4(ob + (long long)r * D + 64 * g + 4 * tx, y);
    }
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int bh, int sq, int skv, Band band, float scale,
                  cudaStream_t stream) {
  constexpr int QS = D + 4, PS = BK + 4;
  constexpr int KP = (BK * QS > BQ * PS) ? BK * QS : BQ * PS;
  constexpr int SMEM = (BQ * QS + KP + BK * D) * (int)sizeof(float);
  // The opt-in to more than 48 KB of dynamic shared memory holds per
  // device, so it is made on every launch (a host-side call).
  cudaError_t e = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  const long long ctas = (long long)n_qtiles * bh;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_f32_kernel<D><<<(unsigned)ctas, NT, SMEM, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, sq, skv,
      n_qtiles, band, scale);
  return last_error();
}

}  // namespace f32

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

// dtype: 0 float32, 1 bfloat16.  d in {64, 128}.  fq, fk: the function's
// (bq, bk) blocks, dividing sq and skv.  window is read when has_window.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int bh, int sq, int skv, int d,
                                   int fq, int fk, int causal, int has_window,
                                   int window, float scale, int dtype,
                                   void* stream) {
  if (bh == 0 || sq == 0) return 0;
  if (fq < 1 || fk < 1 || skv < 1) return (int)cudaErrorInvalidValue;
  const Band band{fq, fk, causal, has_window, window};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && d == 64) return f32::launch<64>(q, k, v, o, bh, sq, skv, band, scale, s);
  if (dtype == 0 && d == 128) return f32::launch<128>(q, k, v, o, bh, sq, skv, band, scale, s);
  if (dtype == 1 && d == 64) return tc::launch<64>(q, k, v, o, bh, sq, skv, band, scale, s);
  if (dtype == 1 && d == 128) return tc::launch<128>(q, k, v, o, bh, sq, skv, band, scale, s);
  return (int)cudaErrorInvalidValue;
}
