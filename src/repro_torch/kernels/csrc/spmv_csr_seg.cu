// Segmented (merge) CSR SpMV under a semiring for Hopper.
//
// Replaces the TPU kernel repro/kernels/spmv_csr_seg.py:spmv_csr_seg_pallas
// (body _kernel) and its carry-out merge in repro/kernels/_layout.py:
// spmv_csr_seg_prepared.  It serves the heavy half of every HYB plan: the
// heavy rows' nonzeros as one flat stream sorted by column (so the x
// gathers ascend), cut into S segments of L slots.
//
// Pass 1, one block per segment: thread t computes slot t's product into
// shared memory, with its dense row rank within the segment.  `order`
// lists the segment's slots sorted by (rank, slot), so the slots of one
// rank form one run of it; thread t marks where each run starts, and
// thread r then folds run r, in slot order, into partials[s, r].  The TPU
// kernel did this fold with a one-hot matmul (it has no scatter); here
// each product is read once, so the pass costs O(L) per segment.
// Pass 2, one thread per row: the row's partials, listed in segment order
// by merge_ptr / merge_idx, are folded into y; a row with none gets the
// ⊕-identity, and `base` (the light ELL result of a HYB plan), when given,
// is ⊕-joined in the same pass.  A power-law hub owns up to tens of
// thousands of partials, which one thread would fold one dependent load
// at a time, so the rows with more than `long_row` partials (listed in
// `long_rows`) are skipped there and merged by a block each: thread j
// folds partials j, j + 256, ..., then a fixed tree joins the threads.
// No atomics, so every run folds in the same order.
//
// Bound on an H100: bytes.  The function needs vals and cols (8 nnz), x
// and the base, and writes y; this layout also reads ranks and order
// (6 nnz more), and the partials add about 8 bytes per (segment, row)
// pair.  The loads of pass 1 are coalesced (thread t reads slot t),
// and the column-sorted stream keeps each segment's x gathers in a few
// neighbouring cache lines.
#include <stdint.h>

#include "semiring.cuh"

constexpr int kMaxSeg = 1024;

template <class SR>
__global__ void spmv_seg_partials_kernel(const float* __restrict__ vals,
                                         const int* __restrict__ cols,
                                         const int* __restrict__ rid,
                                         const int16_t* __restrict__ order,
                                         const float* __restrict__ x,
                                         float* __restrict__ partials,
                                         long long nnz, int seg_len,
                                         int rwin) {
  __shared__ float prod[kMaxSeg];
  __shared__ int rank[kMaxSeg];
  __shared__ int16_t slot_of[kMaxSeg];   // sorted position -> slot
  __shared__ int run_start[kMaxSeg + 1];  // rank -> first sorted position
  __shared__ int n_runs;
  int s = blockIdx.x, t = threadIdx.x;
  long long start = (long long)s * seg_len;
  int n_slots = (int)min((long long)seg_len, nnz - start);
  if (t < n_slots) {
    long long p = start + t;
    prod[t] = SR::mul(__ldg(vals + p), __ldg(x + __ldg(cols + p)));
    rank[t] = __ldg(rid + p);
    slot_of[t] = __ldg(order + p);
  }
  __syncthreads();
  if (t < n_slots) {
    int r = rank[slot_of[t]];
    if (t == 0 || rank[slot_of[t - 1]] != r) run_start[r] = t;
    if (t == n_slots - 1) {
      run_start[r + 1] = n_slots;
      n_runs = r + 1;
    }
  }
  __syncthreads();
  if (t >= rwin) return;
  float acc = SR::identity();
  if (t < n_runs)
    for (int k = run_start[t], end = run_start[t + 1]; k < end; ++k)
      acc = SR::add(acc, prod[slot_of[k]]);
  partials[(long long)s * rwin + t] = acc;
}

template <class SR>
__global__ void spmv_seg_merge_kernel(const float* __restrict__ partials,
                                      const int* __restrict__ merge_ptr,
                                      const int* __restrict__ merge_idx,
                                      const float* __restrict__ base,
                                      float* __restrict__ y, int n_rows,
                                      int long_row) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  int p = merge_ptr[row], end = merge_ptr[row + 1];
  if (end - p > long_row) return;  // spmv_seg_merge_long_kernel's row
  float acc = SR::identity();
  for (; p < end; ++p)
    acc = SR::add(acc, __ldg(partials + __ldg(merge_idx + p)));
  y[row] = base != nullptr ? SR::add(base[row], acc) : acc;
}

constexpr int kMergeThreads = 256;

template <class SR>
__global__ void spmv_seg_merge_long_kernel(const float* __restrict__ partials,
                                           const int* __restrict__ merge_ptr,
                                           const int* __restrict__ merge_idx,
                                           const int* __restrict__ long_rows,
                                           const float* __restrict__ base,
                                           float* __restrict__ y) {
  __shared__ float red[kMergeThreads];
  int row = long_rows[blockIdx.x], t = threadIdx.x;
  float acc = SR::identity();
  for (int p = merge_ptr[row] + t, end = merge_ptr[row + 1]; p < end;
       p += kMergeThreads)
    acc = SR::add(acc, __ldg(partials + __ldg(merge_idx + p)));
  red[t] = acc;
  __syncthreads();
  for (int w = kMergeThreads / 2; w > 0; w >>= 1) {
    if (t < w) red[t] = SR::add(red[t], red[t + w]);
    __syncthreads();
  }
  if (t == 0) y[row] = base != nullptr ? SR::add(base[row], red[0]) : red[0];
}

// partials: (n_segs, rwin) scratch; base: (n_rows,) or null; long_rows:
// the n_long rows with more than long_row partials.
extern "C" int spmv_csr_seg_f32(const void* vals, const void* cols,
                                const void* rid, const void* order,
                                const void* merge_ptr, const void* merge_idx,
                                const void* long_rows, const void* x,
                                const void* base, void* partials, void* y,
                                long long nnz, int n_rows, int n_segs,
                                int seg_len, int rwin, int n_long,
                                int long_row, int semiring, void* stream) {
  if (seg_len > kMaxSeg || rwin > seg_len) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SEMIRING_DISPATCH(semiring, SR,
    if (n_segs > 0)
      spmv_seg_partials_kernel<SR><<<n_segs, seg_len, 0, st>>>(
          (const float*)vals, (const int*)cols, (const int*)rid,
          (const int16_t*)order, (const float*)x, (float*)partials, nnz,
          seg_len, rwin);
    if (n_rows > 0) {
      const int threads = 256;
      spmv_seg_merge_kernel<SR><<<(n_rows + threads - 1) / threads, threads,
                                  0, st>>>(
          (const float*)partials, (const int*)merge_ptr,
          (const int*)merge_idx, (const float*)base, (float*)y, n_rows,
          long_row);
    }
    if (n_long > 0)
      spmv_seg_merge_long_kernel<SR><<<n_long, kMergeThreads, 0, st>>>(
          (const float*)partials, (const int*)merge_ptr,
          (const int*)merge_idx, (const int*)long_rows, (const float*)base,
          (float*)y);)
  return last_error();
}
