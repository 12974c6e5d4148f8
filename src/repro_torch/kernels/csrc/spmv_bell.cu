// Blocked-ELL (BELL) SpMV for Hopper, plus-times:
//   y[b*bm + m] = Σ_k Σ_n blocks[p_k, m, n] * x[bc[p_k]*128 + n],  p_k in block_ptr[b] .. block_ptr[b+1]
//
// Replaces the TPU kernel repro/kernels/spmv_bell.py:spmv_bell_pallas (body
// _kernel), reached through repro/kernels/_layout.py:spmv_bell_prepared.
// The TPU grid runs one program per (block row, block) pair, each one
// (8,128)·(128,) dot_general accumulated into its row block in grid order,
// over a padded (nbr, bpr, 8, 128) container.  The port's prepared layout
// (_layout.prepare_bell) keeps only the blocks that can change y: real
// blocks, in the container's order, with a CSR-like block_ptr per block
// row.  A dropped block is all zero at block column 0, so it adds
// 0*x[0:128] -- +0, or NaN when that tile holds a non-finite value; the
// rows that had one carry a pad0 flag and add that term last, which is
// exact because +0 leaves a sum unchanged and NaN is sticky.
//
// One CTA of bm warps walks block rows (grid-stride).  For each block the
// first warp stages the 128-wide x tile in shared memory (the bm rows of
// the block reuse it); warp m reads row m of the block as one float4 per
// lane (512 coalesced bytes), folds its four products in order, then a
// fixed xor-butterfly over the 32 lanes.  Rows sum their blocks in block
// order with no atomics, so replays are bit-identical, and the plain
// version (spmv_bell.py:spmv_bell_plain) repeats this order exactly.
// The last tile is masked when n_cols % 128 != 0: no x padding in memory.
//
// Bound on an H100: bytes.  It must read 4*bm*128 bytes per real block
// plus its 4-byte block column, x (4 n_cols) and write y (4 n_rows); its
// 2*bm*128 flops per block are 0.5 flop per byte.
#include "semiring.cuh"

#define BN 128

__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

__device__ __forceinline__ float lane_dot(float4 d, float4 v) {
  float s = 0.0f;
  s = __fadd_rn(s, __fmul_rn(d.x, v.x));
  s = __fadd_rn(s, __fmul_rn(d.y, v.y));
  s = __fadd_rn(s, __fmul_rn(d.z, v.z));
  s = __fadd_rn(s, __fmul_rn(d.w, v.w));
  return s;
}

// lane's four entries of x tile `bc`, zero past n_cols
__device__ __forceinline__ float4 x_tile(const float* __restrict__ x,
                                         long long bc, int lane, int n_cols) {
  long long j = bc * BN + 4 * lane;
  float4 v;
  v.x = j + 0 < n_cols ? __ldg(x + j + 0) : 0.0f;
  v.y = j + 1 < n_cols ? __ldg(x + j + 1) : 0.0f;
  v.z = j + 2 < n_cols ? __ldg(x + j + 2) : 0.0f;
  v.w = j + 3 < n_cols ? __ldg(x + j + 3) : 0.0f;
  return v;
}

__global__ void spmv_bell_kernel(const float* __restrict__ blocks,
                                 const int* __restrict__ block_cols,
                                 const int* __restrict__ block_ptr,
                                 const unsigned char* __restrict__ pad0,
                                 const float* __restrict__ x,
                                 float* __restrict__ y,
                                 int n_rows, int n_cols, int n_brows, int bm) {
  __shared__ float4 xs[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // what a dropped block adds: 0 * x[0:128] through the same tree
  const float pad = warp_sum(lane_dot(make_float4(0.f, 0.f, 0.f, 0.f),
                                      x_tile(x, 0, lane, n_cols)));
  for (int b = blockIdx.x; b < n_brows; b += gridDim.x) {
    const int lo = __ldg(block_ptr + b), hi = __ldg(block_ptr + b + 1);
    float acc = 0.0f;
    for (int p = lo; p < hi; ++p) {
      // the block's row is loaded first, so it is in flight across the
      // two barriers that hand the x tile over
      const float4 d = __ldg(reinterpret_cast<const float4*>(
          blocks + ((long long)p * bm + warp) * BN) + lane);
      __syncthreads();                       // the last tile is consumed
      if (warp == 0) xs[lane] = x_tile(x, __ldg(block_cols + p), lane, n_cols);
      __syncthreads();
      acc = __fadd_rn(acc, warp_sum(lane_dot(d, xs[lane])));
    }
    if (pad0[b]) acc = __fadd_rn(acc, pad);
    const long long row = (long long)b * bm + warp;
    if (lane == 0 && row < n_rows) y[row] = acc;
  }
}

extern "C" int spmv_bell_f32(const void* blocks, const void* block_cols,
                             const void* block_ptr, const void* pad0,
                             const void* x, void* y, int n_rows, int n_cols,
                             int n_brows, int bm, void* stream) {
  if (bm < 1 || bm > 32) return (int)cudaErrorInvalidValue;
  const int ctas = n_brows < 132 * 64 ? n_brows : 132 * 64;
  spmv_bell_kernel<<<ctas, 32 * bm, 0, (cudaStream_t)stream>>>(
      (const float*)blocks, (const int*)block_cols, (const int*)block_ptr,
      (const unsigned char*)pad0, (const float*)x, (float*)y, n_rows, n_cols,
      n_brows, bm);
  return last_error();
}
