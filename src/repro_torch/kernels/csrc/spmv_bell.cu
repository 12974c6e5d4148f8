// Blocked-ELL (BELL) SpMV for Hopper, plus-times, on column-compressed
// blocks:
//   y[b*bm + m] = Σ_p Σ_n block_p[m, n] * x[bc_p*128 + n],  p in block_ptr[b] .. block_ptr[b+1]
//
// Replaces the TPU kernel repro/kernels/spmv_bell.py:spmv_bell_pallas (body
// _kernel), reached through repro/kernels/_layout.py:spmv_bell_prepared.
// The TPU grid runs one program per (block row, block) pair, each one
// (8,128)·(128,) dot_general accumulated into its row block in grid order,
// over a padded (nbr, bpr, 8, 128) container.
//
// What bounds it on the card is bytes, and most of a dense block's bytes
// can be zeros: the PageRank operand of a graph of dense 8x128 tiles is
// its transpose, whose 8x128 blocks hold 8 nonzero columns of 128.  So
// the prepared layout (_layout.prepare_bell) keeps, per real block, a
// 128-bit mask of its kept columns (where some row is nonzero) and only
// those columns' values, column by column (bm floats each, explicit zeros
// included), at values[val_ptr[p]].  A dropped column still adds
// 0*x[j] in the function: +0, or NaN when x[j] is not finite.  A first
// pass writes one flag per 128-wide x tile, set when the tile holds a
// non-finite value, and one for the whole of x.  Only when that one is
// set are the tile flags read: a block over a flagged tile checks its
// dropped columns (exact, and rare), and so does a block row the
// container padded (pad0: a dropped block at block column 0 adds
// 0*x[0:128], tile 0's flag), which adds that term last: +0 leaves a sum
// unchanged and NaN is sticky.
//
// A group of bm * lanes lanes per block row, `lanes` per row, chosen by
// the layout from its blocks' mean kept width.  Dense blocks get 32 / bm
// (spmv_bell_row_kernel: a warp per block row, walking its blocks).
// Narrow ones get fewer: 1 for the PageRank operand's 8 kept columns
// (spmv_bell_rows_kernel: 4 block rows of 8 to a warp, stepping through
// their blocks together so they never diverge, at 32 registers so 64
// warps fit an SM).  The time of both is the latency of a block row's
// chain of loads (block_ptr, then mask, offset and tile, then values and
// x), so more rows in flight is what makes the narrow blocks fast.  For
// each block a group turns the mask into the list of kept columns in
// shared memory (each lane ranks its share of the 128 bits with
// popcounts), then lane (g, m) takes row m and the kept columns j = g,
// g + lanes, ... in order (the values are read coalesced and streamed;
// the x gathers stay inside one 512-byte tile), and a fixed xor-butterfly
// over the lanes of a row (offsets bm * lanes / 2 .. bm) joins them.  Rows
// sum their blocks in block order with no atomics, so replays are
// bit-identical, and the plain version (spmv_bell.py:spmv_bell_plain)
// repeats this order exactly.
//
// Bound on an H100: bytes.  It must read each real block's kept values
// (4 bm k), its mask, value offset and block column (28 bytes), x
// (4 n_cols) and write y (4 n_rows); it does 2 bm k flops per block.
#include <stdint.h>

#include "semiring.cuh"

#define BN 128

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void bell_tile_flags_kernel(const float* __restrict__ x,
                                       unsigned char* __restrict__ flags,
                                       int n_cols, int n_tiles) {
  const int tile = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (tile >= n_tiles) return;
  bool bad = false;
  for (int i = 0; i < 4; ++i) {
    const long long j = (long long)tile * BN + 4 * lane + i;
    bad |= j < n_cols && !isfinite(__ldg(x + j));
  }
  bad = __any_sync(kFull, bad);
  if (lane == 0) flags[tile] = bad;
  if (lane == 0 && bad) flags[n_tiles] = 1;   // x holds a non-finite value
}

__device__ __forceinline__ unsigned mask_word(uint4 mk, int w) {
  return w == 0 ? mk.x : w == 1 ? mk.y : w == 2 ? mk.z : mk.w;
}

// One block row to a warp (bm * lanes == 32): the warp walks its blocks.
__global__ void __launch_bounds__(32 * kWarps)
spmv_bell_row_kernel(const float* __restrict__ values,
                     const long long* __restrict__ val_ptr,
                     const uint4* __restrict__ masks,
                     const int* __restrict__ block_cols,
                     const int* __restrict__ block_ptr,
                     const unsigned char* __restrict__ pad0,
                     const unsigned char* __restrict__ flags,
                     const float* __restrict__ x, float* __restrict__ y,
                     int n_rows, int n_cols, int n_tiles, int n_brows,
                     int bm) {
  __shared__ unsigned char colpos[kWarps][BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= n_brows) return;              // whole warps leave together
  const int m = lane % bm, g = lane / bm, lanes = 32 / bm;
  const int word = lane >> 3, shift = (lane & 7) * 4;  // bits 4l .. 4l+3
  const float nan = __int_as_float(0x7fffffff);
  unsigned char* cols = colpos[warp];
  const bool any_bad = flags[n_tiles];
  const int lo = __ldg(block_ptr + b), hi = __ldg(block_ptr + b + 1);
  float acc = 0.0f;
  for (int p = lo; p < hi; ++p) {
    const uint4 mk = __ldg(masks + p);
    const long long base = __ldg(val_ptr + p);
    const long long tile = (long long)__ldg(block_cols + p) * BN;
    const int c0 = __popc(mk.x), c1 = __popc(mk.y), c2 = __popc(mk.z);
    const unsigned nib = (mask_word(mk, word) >> shift) & 0xfu;
    int rank = (word > 0 ? c0 : 0) + (word > 1 ? c1 : 0) +
               (word > 2 ? c2 : 0) +
               __popc(mask_word(mk, word) & ((1u << shift) - 1u));
    for (int i = 0; i < 4; ++i)
      if (nib >> i & 1u) cols[rank++] = (unsigned char)(4 * lane + i);
    const int k = c0 + c1 + c2 + __popc(mk.w);
    __syncwarp();
    float s = 0.0f;
#pragma unroll 4
    for (int j = g; j < k; j += lanes) {
      const long long c = tile + cols[j];
      const float xv = c < n_cols ? __ldg(x + c) : 0.0f;
      s = __fadd_rn(
          s, __fmul_rn(__ldcs(values + base + (long long)j * bm + m), xv));
    }
    __syncwarp();                        // the list is rewritten next block
    for (int off = 16; off >= bm; off >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    if (any_bad && flags[tile / BN]) {   // a dropped column over a non-finite x?
      bool bad = false;
      for (int i = 0; i < 4; ++i) {
        const long long c = tile + 4 * lane + i;
        bad |= !(nib >> i & 1u) && c < n_cols && !isfinite(__ldg(x + c));
      }
      if (__any_sync(kFull, bad)) s = __fadd_rn(s, nan);
    }
    acc = __fadd_rn(acc, s);
  }
  if (pad0[b] && any_bad && flags[0]) acc = __fadd_rn(acc, nan);
  const long long row = (long long)b * bm + m;
  if (g == 0 && row < n_rows) y[row] = acc;
}

// Several block rows to a warp (bm * lanes < 32), stepping together.
__global__ void __launch_bounds__(32 * kWarps, 8)
spmv_bell_rows_kernel(const float* __restrict__ values,
                 const long long* __restrict__ val_ptr,
                 const uint4* __restrict__ masks,
                 const int* __restrict__ block_cols,
                 const int* __restrict__ block_ptr,
                 const unsigned char* __restrict__ pad0,
                 const unsigned char* __restrict__ flags,
                 const float* __restrict__ x, float* __restrict__ y,
                 int n_rows, int n_cols, int n_tiles, int n_brows, int bm,
                 int lanes) {
  extern __shared__ unsigned char colpos[];  // BN per block row of a warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int size = bm * lanes, per_warp = 32 / size;  // lanes of a block row
  const int grp = lane / size, ll = lane % size;
  const int m = ll % bm, g = ll / bm;
  const long long first_row =
      ((long long)blockIdx.x * kWarps + warp) * per_warp;
  if (first_row >= n_brows) return;      // whole warps leave together
  const long long b = first_row + grp;
  unsigned char* cols = colpos + (warp * per_warp + grp) * BN;
  const int bits = BN / size, first_bit = ll * bits;
  const float nan = __int_as_float(0x7fffffff);
  const bool row_ok = b < n_brows;
  const int lo = row_ok ? __ldg(block_ptr + b) : 0;
  const int nblk = row_ok ? __ldg(block_ptr + b + 1) - lo : 0;
  const bool padded = row_ok && pad0[b];
  const bool any_bad = flags[n_tiles];   // tile flags are read only then
  // the warp's block rows step through their blocks together (no
  // divergence between them): step t takes block lo + t of each row
  const int steps = __reduce_max_sync(kFull, nblk);
  float acc = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const bool has = t < nblk;
    uint4 mk = make_uint4(0u, 0u, 0u, 0u);
    long long base = 0, tile = 0;
    if (has) {
      mk = __ldg(masks + lo + t);
      base = __ldg(val_ptr + lo + t);
      tile = (long long)__ldg(block_cols + lo + t) * BN;
    }
    const bool flagged = any_bad && has && flags[tile / BN];
    // the kept columns, ascending: lane ll ranks bits [first_bit, +bits)
    int rank = 0, k = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const unsigned word = mask_word(mk, w);
      const int below = min(max(first_bit - 32 * w, 0), 32);
      rank += __popc(below == 32 ? word : word & ((1u << below) - 1u));
      k += __popc(word);
    }
    if (bits <= 32) {                    // the lane's bits lie in one word
      const unsigned chunk = mask_word(mk, first_bit >> 5) >> (first_bit & 31);
      for (unsigned mine = bits == 32 ? chunk : chunk & ((1u << bits) - 1u);
           mine; mine &= mine - 1u)
        cols[rank++] = (unsigned char)(first_bit + __ffs(mine) - 1);
    } else {
      for (int i = 0; i < bits; ++i) {
        const int n = first_bit + i;
        if (mask_word(mk, n >> 5) >> (n & 31) & 1u)
          cols[rank++] = (unsigned char)n;
      }
    }
    const int k_max = __reduce_max_sync(kFull, k);
    __syncwarp();
    float s = 0.0f;
#pragma unroll 8
    for (int j = g; j < k_max; j += lanes) {
      if (j < k) {
        const long long c = tile + cols[j];
        const float xv = c < n_cols ? __ldg(x + c) : 0.0f;
        s = __fadd_rn(
            s, __fmul_rn(__ldcs(values + base + (long long)j * bm + m), xv));
      }
    }
    __syncwarp();                        // the lists are rewritten next step
    for (int off = size / 2; off >= bm; off >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
    if (__any_sync(kFull, flagged)) {    // a dropped column over a non-finite x?
      bool bad = false;
      for (int i = 0; flagged && i < bits; ++i) {
        const int n = first_bit + i;
        bad |= !(mask_word(mk, n >> 5) >> (n & 31) & 1u) &&
               tile + n < n_cols && !isfinite(__ldg(x + tile + n));
      }
      const unsigned group =
          size == 32 ? kFull : ((1u << size) - 1u) << (grp * size);
      if (__ballot_sync(kFull, bad) & group) s = __fadd_rn(s, nan);
    }
    if (has) acc = __fadd_rn(acc, s);
  }
  if (padded && any_bad && flags[0]) acc = __fadd_rn(acc, nan);
  const long long row = b * bm + m;
  if (row_ok && g == 0 && row < n_rows) y[row] = acc;
}

// flags: (ceil(n_cols / 128) + 1,) scratch, written by the first pass
// (the last byte: any tile flagged);
// lanes: lanes per row (a power of two, bm * lanes <= 32).
extern "C" int spmv_bell_f32(const void* values, const void* val_ptr,
                             const void* masks, const void* block_cols,
                             const void* block_ptr, const void* pad0,
                             const void* x, void* flags, void* y, int n_rows,
                             int n_cols, int n_brows, int bm, int lanes,
                             void* stream) {
  if (bm < 1 || lanes < 1 || (lanes & (lanes - 1)) || 32 % (bm * lanes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int n_tiles = n_cols > 0 ? (n_cols + BN - 1) / BN : 1;
  cudaMemsetAsync((unsigned char*)flags + n_tiles, 0, 1, st);
  bell_tile_flags_kernel<<<(n_tiles + kWarps - 1) / kWarps, 32 * kWarps, 0,
                           st>>>((const float*)x, (unsigned char*)flags,
                                 n_cols, n_tiles);
  const int per_warp = 32 / (bm * lanes);
  const long long warps = (n_brows + per_warp - 1) / per_warp;
  const int ctas = (int)((warps + kWarps - 1) / kWarps);
  if (n_brows > 0 && per_warp > 1)
    spmv_bell_rows_kernel<<<ctas, 32 * kWarps, kWarps * per_warp * BN, st>>>(
        (const float*)values, (const long long*)val_ptr, (const uint4*)masks,
        (const int*)block_cols, (const int*)block_ptr,
        (const unsigned char*)pad0, (const unsigned char*)flags,
        (const float*)x, (float*)y, n_rows, n_cols, n_tiles, n_brows, bm,
        lanes);
  else if (n_brows > 0)
    spmv_bell_row_kernel<<<ctas, 32 * kWarps, 0, st>>>(
        (const float*)values, (const long long*)val_ptr, (const uint4*)masks,
        (const int*)block_cols, (const int*)block_ptr,
        (const unsigned char*)pad0, (const unsigned char*)flags,
        (const float*)x, (float*)y, n_rows, n_cols, n_tiles, n_brows, bm);
  return last_error();
}
