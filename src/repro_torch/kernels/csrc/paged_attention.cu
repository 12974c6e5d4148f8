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
// Here each KV row is read once, and only the table entries j <
// ceil(length / block) (clamped to max_blocks) are dereferenced -- a
// stale or garbage entry past the length is never read.  An entry below
// that bound that lies outside [0, n_blocks) makes the sequence's output
// NaN instead of reading out of bounds (the plain version does the same).
//
// Bound on an H100: bytes.  Each visible token costs 2·KVH·hd elements of
// K and V (4 KB per token at Granite-8B's 8 x 128 in bf16) for 4·H·hd
// flops: one flop per byte in bf16, far under the card's 295.  What held
// the first design (a CTA per (sequence, KV head) walking its whole
// sequence) back was not bytes but its longest sequence's chain: 64
// chunks in series, each waiting for its own loads.
//
// Two kernels a call:
//   paged_split_kernel  splits every sequence's walk into spans of `span`
//     tokens (a multiple of the block and of CH; the wrapper picks 512):
//     one CTA of 128 threads per (sequence, KV head, span), serving the g
//     = H/KVH query heads of its group.  The grid is sized from the shapes
//     alone (max_blocks·block / span spans a sequence), so the lengths
//     stay on the card; a CTA whose span starts at or past its sequence's
//     length exits at once.  The span's table entries are read and
//     checked first (a bad one sets the span's flag and ends the CTA).
//     K and V rows come into a two-stage ring of CH-token chunks through
//     cp.async, 16 bytes a lane in both dtypes (a bf16 row of 128 values
//     is 16 lanes), one chunk ahead of the one computed (on the card a
//     third or fourth stage was slower: the smaller ring fits more CTAs
//     on an SM, 32 KB of ring in bf16 at hd 128, 64 KB in float32).  Per
//     chunk: each token row's dot with the group's query heads (lanes of
//     a row reduce by xor butterflies); one warp per head takes the
//     chunk's max and Σ with shuffles, turning scores into p; then each
//     thread accumulates 16 bytes' worth of hd for every head over its
//     share of the chunk's tokens.  At the end the token groups' sums are
//     folded in group order and the span writes its partial (m, l,
//     acc[hd]) per query head, in float32, to the workspace.
//   paged_merge_kernel  folds a query head's spans in split order 0..n-1:
//     m = max mᵢ, l = Σ lᵢ·e^(mᵢ-m), acc = Σ accᵢ·e^(mᵢ-m), out = acc / l
//     (0 where l = 0: length <= 0 walks nothing), NaN if any span of the
//     sequence flagged a bad entry.
// Positions at or past the length are never loaded and count as p = 0 --
// what the TPU kernel's -1e30 mask gives them, since every span starts
// below the length and so holds a real score.  Heads past g in the group
// template bound GT in {1, 4, 16} hold q = 0 and are never stored.  No
// atomics and fixed summation orders: two launches are bit-identical.
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

#define NT 128            // threads per CTA
#define CH 32             // tokens per chunk (the wrapper's CHUNK)
#define ST 2              // stages of the K/V ring
#define GMAX 16           // query heads per KV head at most
#define SENTINEL (-1e30f) // the TPU kernel's NEG_INF: m's initial value

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(uint4 u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x); x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z); x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(uint4 u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

// the workspace: acc (B, H, n_split, hd), then (m, l) (B, H, n_split), then
// the flags (B, KVH, n_split) as int
struct Parts {
  float* acc;
  float2* ml;
  int* flags;
};

static Parts parts(void* ws, int B, int H, int KVH, int hd, int n_split) {
  const long long rows = (long long)B * H * n_split;
  float* acc = (float*)ws;
  float2* ml = (float2*)(acc + rows * hd);
  return {acc, ml, (int*)(ml + rows)};
}

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(NT)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ tables,
                   const int* __restrict__ lengths, Parts ws, int H, int KVH,
                   int n_blocks, int block, int max_blocks, int span,
                   int n_split, float scale) {
  constexpr int VPL = 16 / sizeof(T);    // values per 16-byte piece
  constexpr int LPT = HD / VPL;          // pieces (lanes) per token row
  constexpr int TPW = 32 / LPT;          // token rows a warp takes at once
  constexpr int NTG = NT / LPT;          // token groups of the P V phase
  constexpr int RING = ST * CH * LPT;    // 16-byte pieces of one ring
  extern __shared__ uint4 smem[];
  uint4* kring = smem;                   // [ST][CH][LPT]
  uint4* vring = kring + RING;
  float* qs = reinterpret_cast<float*>(vring + RING);   // [GT][HD]
  float* ss = qs + GT * HD;              // [GT][CH]: scores, then p
  float* ms = ss + GT * CH;              // [GT] each: m, l, corr
  float* ls = ms + GT;
  float* cs = ls + GT;
  int* ids = reinterpret_cast<int*>(cs + GT);           // the span's entries

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x % n_split;
  const int bk = blockIdx.x / n_split, kh = bk % KVH, b = bk / KVH;
  const int g = H / KVH;
  const int len = lengths[b];
  const long long n_pos = (long long)max_blocks * block;
  const long long n_tok = len <= 0 ? 0 : (len < n_pos ? len : n_pos);
  const long long span0 = (long long)split * span;
  if (span0 >= n_tok) return;            // the merge reads no part of it
  const int n_here = (int)min((long long)span, n_tok - span0);
  const int j0 = (int)(span0 / block), nj = (n_here + block - 1) / block;
  const int* tb = tables + (long long)b * max_blocks + j0;
  const long long slot = (long long)bk * n_split + split;

  bool bad = false;
  for (int j = tid; j < nj; j += NT) {
    const int id = tb[j];
    bad = bad || id < 0 || id >= n_blocks;
    ids[j] = id;
  }
  if (__syncthreads_or(bad)) {
    if (tid == 0) ws.flags[slot] = 1;
    return;
  }
  if (tid == 0) ws.flags[slot] = 0;

  // chunk c of the span (tokens c·CH ..) into ring stage c % ST; rows at
  // or past the length are not loaded
  const auto load = [&](int c) {
    const int t0 = c * CH, st = c % ST;
#pragma unroll
    for (int e = tid; e < CH * LPT; e += NT) {
      const int t = e / LPT, piece = e % LPT, tt = t0 + t;
      if (tt < n_here) {
        const long long row =
            ((long long)ids[tt / block] * block + tt % block) * KVH + kh;
        const int at = (st * CH + t) * LPT + piece;
        cp_async16(kring + at, kp + row * HD + piece * VPL);
        cp_async16(vring + at, vp + row * HD + piece * VPL);
      }
    }
  };
  const int n_chunks = (n_here + CH - 1) / CH;
#pragma unroll
  for (int c = 0; c < ST - 1; ++c) {
    if (c < n_chunks) load(c);
    cp_async_commit();
  }

  const long long q_row = (long long)b * H + (long long)kh * g;
  for (int e = tid; e < GT * HD; e += NT) {
    const int h = e / HD;
    qs[e] = h < g ? to_float(q[(q_row + h) * HD + e % HD]) : 0.f;
  }
  if (tid < GT) {
    ms[tid] = SENTINEL;
    ls[tid] = 0.f;
  }
  float acc[GT][VPL];
#pragma unroll
  for (int h = 0; h < GT; ++h)
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[h][i] = 0.f;

  const int sub = lane / LPT, part = lane % LPT;   // dot phase
  const int tg = tid / LPT;                        // P V phase (part as above)
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<ST - 2>();     // this thread's copies of chunk c are in
    __syncthreads();             // everyone's; chunk c - 1 is consumed
    if (c + ST - 1 < n_chunks) load(c + ST - 1);
    cp_async_commit();
    const int st = c % ST, n_c = min(CH, n_here - c * CH);

#pragma unroll
    for (int u = 0; u < CH / (4 * TPW); ++u) {
      const int t = (u * 4 + warp) * TPW + sub;
      float kx[VPL];
      unpack(kring[(st * CH + t) * LPT + part], kx);
      float d[GT];
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        const float4* qh = reinterpret_cast<const float4*>(qs + h * HD + part * VPL);
        d[h] = 0.f;
#pragma unroll
        for (int i = 0; i < VPL / 4; ++i) {
          const float4 a = qh[i];
          d[h] = fmaf(a.x, kx[4 * i], d[h]);
          d[h] = fmaf(a.y, kx[4 * i + 1], d[h]);
          d[h] = fmaf(a.z, kx[4 * i + 2], d[h]);
          d[h] = fmaf(a.w, kx[4 * i + 3], d[h]);
        }
      }
#pragma unroll
      for (int off = LPT / 2; off > 0; off >>= 1)
#pragma unroll
        for (int h = 0; h < GT; ++h)
          d[h] += __shfl_xor_sync(0xffffffffu, d[h], off);
      if (part == 0) {
#pragma unroll
        for (int h = 0; h < GT; ++h) ss[h * CH + t] = t < n_c ? d[h] * scale : -INFINITY;
      }
    }
    __syncthreads();

    for (int h = warp; h < GT; h += NT / 32) {
      const float s = ss[h * CH + lane];
      const float m_prev = ms[h];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float sum = warp_sum(p);
      ss[h * CH + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        cs[h] = corr;
        ls[h] = ls[h] * corr + sum;
        ms[h] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int h = 0; h < GT; ++h) {
      const float corr = cs[h];
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[h][i] *= corr;
    }
    for (int t = tg; t < n_c; t += NTG) {
      float vx[VPL];
      unpack(vring[(st * CH + t) * LPT + part], vx);
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        const float p = ss[h * CH + t];
#pragma unroll
        for (int i = 0; i < VPL; ++i) acc[h][i] = fmaf(p, vx[i], acc[h][i]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();               // the rings are free; ms and ls are final

  // fold the token groups' sums in group order, one head at a time,
  // through the K ring
  float* red = reinterpret_cast<float*>(kring);   // [NTG][HD]
  const long long row0 = (q_row * n_split + split);
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    if (h >= g) break;
#pragma unroll
    for (int i = 0; i < VPL; ++i) red[tg * HD + part * VPL + i] = acc[h][i];
    __syncthreads();
    for (int e = tid; e < HD; e += NT) {
      float sum = red[e];
      for (int k = 1; k < NTG; ++k) sum += red[k * HD + e];
      ws.acc[(row0 + (long long)h * n_split) * HD + e] = sum;
    }
    __syncthreads();
  }
  if (tid < g) ws.ml[row0 + (long long)tid * n_split] = make_float2(ms[tid], ls[tid]);
}

template <typename T>
__global__ void __launch_bounds__(NT)
paged_merge_kernel(const int* __restrict__ lengths, Parts ws, T* __restrict__ out,
                   int H, int KVH, int hd, int block, int max_blocks, int span,
                   int n_split) {
  const int b = blockIdx.x / H, h = blockIdx.x % H, kh = h / (H / KVH);
  const int len = lengths[b];
  const long long n_pos = (long long)max_blocks * block;
  const long long n_tok = len <= 0 ? 0 : (len < n_pos ? len : n_pos);
  const int n_live = (int)((n_tok + span - 1) / span);
  const long long row0 = ((long long)b * H + h) * n_split;
  const int* flags = ws.flags + ((long long)b * KVH + kh) * n_split;
  bool bad = false;
  for (int i = 0; i < n_live; ++i) bad = bad || flags[i] != 0;
  float m = SENTINEL;
  for (int i = 0; i < n_live && !bad; ++i) m = fmaxf(m, ws.ml[row0 + i].x);
  float l = 0.f;
  for (int i = 0; i < n_live && !bad; ++i) {
    const float2 p = ws.ml[row0 + i];
    l += p.y * expf(p.x - m);
  }
  for (int e = threadIdx.x; e < hd; e += NT) {
    float y;
    if (bad) {
      y = __int_as_float(0x7fc00000);
    } else {
      float a = 0.f;
      for (int i = 0; i < n_live; ++i)
        a += ws.acc[(row0 + i) * hd + e] * expf(ws.ml[row0 + i].x - m);
      y = l != 0.f ? a / l : 0.f;
    }
    out[((long long)b * H + h) * hd + e] = from_float<T>(y);
  }
}

template <typename T, int HD, int GT>
static int launch(const void* q, const void* kp, const void* vp,
                  const void* tables, const void* lengths, void* out, int B,
                  int H, int KVH, int n_blocks, int block, int max_blocks,
                  int span, int n_split, float scale, Parts ws,
                  cudaStream_t stream) {
  const long long ctas = (long long)B * KVH * n_split;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_ids = span / block;
  const int smem = 2 * ST * CH * HD * (int)sizeof(T) +
                   (GT * HD + GT * CH + 3 * GT + n_ids) * 4;
  // The opt-in to more than 48 KB of dynamic shared memory holds per
  // device, so it is made on every launch (a host-side call).
  cudaError_t e = cudaFuncSetAttribute(
      paged_split_kernel<T, HD, GT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (ctas > 0)
    paged_split_kernel<T, HD, GT><<<(unsigned)ctas, NT, smem, stream>>>(
        (const T*)q, (const T*)kp, (const T*)vp, (const int*)tables,
        (const int*)lengths, ws, H, KVH, n_blocks, block, max_blocks, span,
        n_split, scale);
  const int err = last_error();
  if (err != 0) return err;
  paged_merge_kernel<T><<<(unsigned)(B * H), NT, 0, stream>>>(
      (const int*)lengths, ws, (T*)out, H, KVH, HD, block, max_blocks, span,
      n_split);
  return last_error();
}

// dtype: 0 float32, 1 bfloat16.  hd in {32, 64, 128}; H / KVH <= 16.
// span: tokens a CTA walks, a multiple of CH and of block; n_split =
// ceil(max_blocks·block / span).  ws: the workspace of B·H·n_split·(hd +
// 2) + B·KVH·n_split 4-byte words (the wrapper's `split_plan`).
extern "C" int paged_attention_fwd(const void* q, const void* kp, const void* vp,
                                   const void* tables, const void* lengths,
                                   void* out, int B, int H, int KVH, int hd,
                                   int n_blocks, int block, int max_blocks,
                                   int span, int n_split, float scale,
                                   int dtype, void* ws, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (KVH < 1 || H % KVH || H / KVH > GMAX || block < 1 || max_blocks < 0 ||
      span < CH || span % CH || span % block || n_split < 0 ||
      (long long)n_split * span < (long long)max_blocks * block ||
      span / block > 4096 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int g = H / KVH;
  const Parts p = parts(ws, B, H, KVH, hd, n_split);
#define PAGED_CASE(T, D, G)                                                     \
  return launch<T, D, G>(q, kp, vp, tables, lengths, out, B, H, KVH, n_blocks, \
                         block, max_blocks, span, n_split, scale, p, s)
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
