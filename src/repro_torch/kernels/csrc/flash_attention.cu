// Flash attention for Hopper: out = softmax(q kᵀ / √d) v per (batch·head),
// under a causal and/or sliding-window mask, f32 or bf16 in, f32 inside.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (body _kernel), reached through
// repro/kernels/ops.py:flash_attention.  The TPU grid is (bh, q block,
// kv block) over the function's (bq, bk) = (min(128, sq), min(128, skv))
// blocks; the kv axis runs in order and carries m, l and acc in VMEM
// scratch, and a kv block out of the (causal, window) band is skipped
// whole.  Here one CTA of 256 threads owns 64 query rows of one bh and
// walks the kv axis itself in 64-key tiles, with m, l and acc in
// registers.  What the function computes depends on the TPU's block grid
// (a row whose relevant block holds no unmasked key comes out as the mean
// of v over that block, because the -1e30 sentinel gives exp(0) = 1), so
// every (row, key) pair is classified on the FUNCTION's grid, whatever the
// CUDA tile:
//   its (bq, bk) block pair is not relevant -> absent  (-inf: p = 0)
//   relevant but masked                      -> -1e30   (the sentinel)
//   relevant and visible                     -> q·k * scale
// A tile whose every pair is absent is skipped, as the TPU skips a block.
// Online softmax as in the TPU body: m_new = max(m, rowmax), p = exp(s -
// m_new), l = l·corr + Σp, acc = acc·corr + p v, and out = 0 where l = 0.
//
// Design: Q (64 x d) stays in shared memory for the CTA's life; per kv
// tile K and V are staged as f32 (converted from bf16 on the load), each
// thread computes a 4 x 4 block of scores with float4 shared-memory reads
// and f32 FMAs, the row max and sum go through a 16-lane xor butterfly,
// P overwrites K's buffer, and each thread accumulates 4 rows x d/16
// columns of P V.  About 100 KB of shared memory at d = 128, so two CTAs
// share an SM.  No atomics: two launches on the same input are
// bit-identical.
//
// Bound on an H100: operations.  Every visible (q, k) pair costs 4d
// float32 flops (q·k and p·v), against about 2·bh·(sq + skv)·d·bytes of
// traffic; at d = 128 over 4096 keys that is several hundred flops per
// byte, far above the card's 20 flop/byte for float32 FMA (67 TFLOP/s
// over 3.35 TB/s).  This first design runs on the FMA units; the tensor
// cores (989 TFLOP/s bf16) are the redesign's.
#include <cuda_bf16.h>

#include "common.cuh"

#define BQ 64              // query rows per CTA
#define BK 64              // keys per tile
#define NT 256             // threads per CTA: 16 row groups x 16 lanes
#define SENTINEL (-1e30f)  // the TPU kernel's NEG_INF

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&a);
  u.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
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

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
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
  const T* qb = q + (long long)bh * sq * D;
  const T* kb = k + (long long)bh * skv * D;
  const T* vb = v + (long long)bh * skv * D;
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

  T* ob = o + (long long)bh * sq * D;
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

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int bh, int sq, int skv, Band band, float scale,
                  cudaStream_t stream) {
  constexpr int QS = D + 4, PS = BK + 4;
  constexpr int KP = (BK * QS > BQ * PS) ? BK * QS : BQ * PS;
  constexpr int SMEM = (BQ * QS + KP + BK * D) * (int)sizeof(float);
  // The opt-in to more than 48 KB of dynamic shared memory holds per
  // device, so it is made on every launch (a host-side call).
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  const long long ctas = (long long)n_qtiles * bh;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_kernel<T, D><<<(unsigned)ctas, NT, SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, sq, skv, n_qtiles, band, scale);
  return last_error();
}

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
  if (dtype == 0 && d == 64) return launch<float, 64>(q, k, v, o, bh, sq, skv, band, scale, s);
  if (dtype == 0 && d == 128) return launch<float, 128>(q, k, v, o, bh, sq, skv, band, scale, s);
  if (dtype == 1 && d == 64) return launch<__nv_bfloat16, 64>(q, k, v, o, bh, sq, skv, band, scale, s);
  if (dtype == 1 && d == 128) return launch<__nv_bfloat16, 128>(q, k, v, o, bh, sq, skv, band, scale, s);
  return (int)cudaErrorInvalidValue;
}
