// Paged decode attention for Hopper: one query token per sequence against
// that sequence's KV, which lies in a pool of fixed-size blocks reached
// through its block table; grouped-query attention (GQA) in the kernel.
//
//   q (B, H, hd), pools (n_blocks, block, KVH, hd), tables (B, max_blocks)
//   int32, lengths (B,) int32 -> out (B, H, hd); query head h reads KV
//   head h / (H / KVH), f32 or bf16 in, f32 inside.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// paged_attention_pallas (body _kernel), reached through
// repro/kernels/ops.py:paged_attention.  The TPU grid is (B, max_blocks):
// the BlockSpec index map dereferences tables[b, j] for EVERY j, so the
// DMA engine fetches a pool block even past the sequence's length (the
// compute is then skipped), and the wrapper first repeats the pools'
// KVH heads to H (jnp.repeat), so each KV block is read H/KVH times.
// Here one CTA of 128 threads serves one (sequence, KV head) and the
// g = H/KVH query heads of its group: it reads each KV row once, and it
// dereferences only the table entries j < ceil(length / block) (clamped
// to max_blocks) -- a stale or garbage entry past the length is never
// read.  An entry below that bound that lies outside [0, n_blocks) makes
// the group's output NaN instead of reading out of bounds (the plain
// version does the same).
//
// Per chunk of 64 tokens: every thread issues its K and V loads first
// (16-byte loads, one token row of hd values per hd/4 lanes); each token
// row's dot with the query heads reduces over its lanes with xor
// butterflies, the heads' chains interleaved (the group size is a
// template bound GT in {1, 4, 16}, the least one >= g: 18 instances in
// all, since each costs build time on every fresh machine; heads past g
// hold q = 0 and are never stored, which costs a g = 2 or 8 group dot
// products on the FMA units, not bytes); one warp per head takes the
// chunk's max and Σ with
// shuffles and turns the scores into p; each thread then accumulates a
// float4 of hd for up to four heads.  Positions at or past the length are never
// loaded and count as p = 0 -- exactly what the TPU kernel's -1e30 mask
// gives them, since every chunk starts below the length and so holds a
// real score.  Length 0 (or below) walks no block: l = 0 and the output
// is 0.  Online softmax as in the TPU body; no atomics, so two launches
// are bit-identical.
//
// Bound on an H100: bytes.  Each visible token costs 2·KVH·hd elements of
// K and V (4 KB per token at Granite-8B's 8 x 128 in bf16) for 4·H·hd
// flops: one flop per byte in bf16, far under the card's 295.
#include <cuda_bf16.h>

#include "common.cuh"

#define NT 128            // threads per CTA
#define CH 64             // tokens per chunk
#define GMAX 16           // query heads per KV head at most
#define SENTINEL (-1e30f) // the TPU kernel's NEG_INF: m's initial value

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(NT)
paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
             const T* __restrict__ vp, const int* __restrict__ tables,
             const int* __restrict__ lengths, T* __restrict__ out, int H,
             int KVH, int n_blocks, int block, int max_blocks, float scale) {
  constexpr int LPT = HD / 4;            // lanes per token row (float4 each)
  constexpr int TPW = 32 / LPT;          // token rows a warp takes at once
  constexpr int KPT = CH / (4 * TPW);    // token rows per lane group per chunk
  constexpr int VPT = CH * LPT / NT;     // V float4 loads per thread per chunk
  constexpr int NSLOT = NT / LPT;        // head slots of the P V phase
  constexpr int HPT = (GT + NSLOT - 1) / NSLOT;
  __shared__ float4 qs[GT][LPT];
  __shared__ float ss[GT][CH];           // scores, then p
  __shared__ float4 vs[CH][LPT];
  __shared__ long long rows[CH];         // pool row of each token, -1 = none
  __shared__ float ms[GT], ls[GT], cs[GT];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / KVH, kh = blockIdx.x % KVH;
  const int g = H / KVH;
  const int len = lengths[b];
  const long long n_pos = (long long)max_blocks * block;
  const int n_tok = len <= 0 ? 0 : (int)(len < n_pos ? len : n_pos);
  const int nb = (n_tok + block - 1) / block;
  const int* tb = tables + (long long)b * max_blocks;
  const long long q_row = (long long)b * H + (long long)kh * g;

  bool bad = false;
  for (int j = tid; j < nb; j += NT) {
    const int id = tb[j];
    bad = bad || id < 0 || id >= n_blocks;
  }
  if (__syncthreads_or(bad)) {
    for (int e = tid; e < g * HD; e += NT)
      out[q_row * HD + e] = from_float<T>(__int_as_float(0x7fc00000));
    return;
  }

  for (int e = tid; e < GT * LPT; e += NT) {
    const int h = e / LPT, c = e % LPT;
    qs[h][c] = h < g ? load4(q + (q_row + h) * HD + 4 * c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < GT) {
    ms[tid] = SENTINEL;
    ls[tid] = 0.f;
  }
  float4 acc[HPT];
#pragma unroll
  for (int k = 0; k < HPT; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int sub = lane / LPT, part = lane % LPT;   // dot phase
  const int slot = tid / LPT, col = tid % LPT;     // P V phase
  for (int c0 = 0; c0 < n_tok; c0 += CH) {
    __syncthreads();             // the last chunk's p and V are consumed
    if (tid < CH) {
      const int t = c0 + tid;
      rows[tid] = t < n_tok
          ? ((long long)tb[t / block] * block + t % block) * KVH + kh : -1;
    }
    __syncthreads();

    float4 kv[KPT], vv[VPT];
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const long long r = rows[(u * 4 + warp) * TPW + sub];
      kv[u] = r >= 0 ? load4(kp + r * HD + 4 * part) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int e = tid + u * NT;
      const long long r = rows[e / LPT];
      vv[u] = r >= 0 ? load4(vp + r * HD + 4 * (e % LPT)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int e = tid + u * NT;
      vs[e / LPT][e % LPT] = vv[u];
    }
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const int t = (u * 4 + warp) * TPW + sub;
      float d[GT];
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        const float4 a = qs[h][part];
        d[h] = a.x * kv[u].x;
        d[h] = fmaf(a.y, kv[u].y, d[h]);
        d[h] = fmaf(a.z, kv[u].z, d[h]);
        d[h] = fmaf(a.w, kv[u].w, d[h]);
      }
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
        for (int h = 0; h < GT; ++h)
          d[h] += __shfl_xor_sync(0xffffffffu, d[h], off);
      if (part == 0) {
        const bool real = rows[t] >= 0;
#pragma unroll
        for (int h = 0; h < GT; ++h) ss[h][t] = real ? d[h] * scale : -INFINITY;
      }
    }
    __syncthreads();

    for (int h = warp; h < GT; h += NT / 32) {
      const float s0 = ss[h][lane], s1 = ss[h][lane + 32];
      const float m_prev = ms[h];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      ss[h][lane] = p0;
      ss[h][lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[h] = corr;
        ls[h] = ls[h] * corr + sum;
        ms[h] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < HPT; ++k) {
      const int h = slot + k * NSLOT;
      if (h < GT) {
        const float c = cs[h];
        acc[k].x *= c; acc[k].y *= c; acc[k].z *= c; acc[k].w *= c;
      }
    }
    const int n_here = min(CH, n_tok - c0);
    for (int t = 0; t < n_here; ++t) {
      const float4 w = vs[t][col];
#pragma unroll
      for (int k = 0; k < HPT; ++k) {
        const int h = slot + k * NSLOT;
        if (h < GT) {
          const float p = ss[h][t];
          acc[k].x = fmaf(p, w.x, acc[k].x);
          acc[k].y = fmaf(p, w.y, acc[k].y);
          acc[k].z = fmaf(p, w.z, acc[k].z);
          acc[k].w = fmaf(p, w.w, acc[k].w);
        }
      }
    }
  }
  __syncthreads();               // ls is final

#pragma unroll
  for (int k = 0; k < HPT; ++k) {
    const int h = slot + k * NSLOT;
    if (h < g) {
      const float l = ls[h];
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (l != 0.f)
        y = make_float4(acc[k].x / l, acc[k].y / l, acc[k].z / l, acc[k].w / l);
      store4(out + (q_row + h) * HD + 4 * col, y);
    }
  }
}

template <typename T, int HD, int GT>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* tables, const void* lengths, void* out, int B,
                  int H, int KVH, int n_blocks, int block, int max_blocks,
                  float scale, cudaStream_t stream) {
  const long long ctas = (long long)B * KVH;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  paged_kernel<T, HD, GT><<<(unsigned)ctas, NT, 0, stream>>>(
      (const T*)q, (const T*)kp, (const T*)vp, (const int*)tables,
      (const int*)lengths, (T*)out, H, KVH, n_blocks, block, max_blocks, scale);
  return last_error();
}

// dtype: 0 float32, 1 bfloat16.  hd in {32, 64, 128}; H / KVH <= 16.
extern "C" int paged_attention_fwd(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* lengths,
                                   void* out, int B, int H, int KVH, int hd,
                                   int n_blocks, int block, int max_blocks,
                                   float scale, int dtype, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (KVH < 1 || H % KVH || H / KVH > GMAX || block < 1 || max_blocks < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = H / KVH;
#define PAGED_CASE(T, D, G)                                                     \
  return launch<T, D, G>(q, kp, vp, tables, lengths, out, B, H, KVH, n_blocks, \
                         block, max_blocks, scale, s)
#define PAGED_GROUPS(T, D)                   \
  {                                          \
    if (g == 1) PAGED_CASE(T, D, 1);         \
    if (g <= 4) PAGED_CASE(T, D, 4);         \
    PAGED_CASE(T, D, 16);                    \
  }
  if (dtype == 0) {
    if (hd == 32) PAGED_GROUPS(float, 32);
    if (hd == 64) PAGED_GROUPS(float, 64);
    if (hd == 128) PAGED_GROUPS(float, 128);
  } else if (dtype == 1) {
    if (hd == 32) PAGED_GROUPS(__nv_bfloat16, 32);
    if (hd == 64) PAGED_GROUPS(__nv_bfloat16, 64);
    if (hd == 128) PAGED_GROUPS(__nv_bfloat16, 128);
  }
#undef PAGED_GROUPS
#undef PAGED_CASE
  return (int)cudaErrorInvalidValue;
}
