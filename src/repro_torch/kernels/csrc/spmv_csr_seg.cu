// Segmented (merge-path) CSR SpMV under a semiring for Hopper.
//
// Replaces the TPU kernel repro/kernels/spmv_csr_seg.py:spmv_csr_seg_pallas
// (body _kernel) and its carry-out merge in repro/kernels/_layout.py:
// spmv_csr_seg_prepared.  It serves the heavy half of every HYB plan (the
// heavy rows' nonzeros, in row order) and the 'csr-seg' plans:
//   y[row] = base[row] ⊕ (⊕ over the row's nonzeros of vals ⊗ x[cols]).
//
// The merge path is the sequence of the n_rows row ends and the nnz
// nonzeros, each row's nonzeros followed by its end; it is cut into windows
// of `window` items, and win_row[w] counts the rows that end before window
// w (the host's diagonal search).  Every row with a nonzero-free stretch of
// rows around it (the light rows of a HYB plan) is an item too, so a window
// holds at most `window` rows and nonzeros together, whatever the skew.
//
// Pass 1, one CTA per window.  The CTA stages its nonzeros' products
// (vals and cols read once, coalesced, as streaming loads that leave x in
// L2) and the end offsets and bases of the rows that end in it, in 12 *
// window bytes of shared memory (at most 6 CTAs an SM: 40 registers a
// thread, and room left in L1 for x).  Thread t walks items
// [t*ipt, (t+1)*ipt) of the window in order (a merge-path search in
// shared memory finds where they start), folding each row's run; a row
// that starts and ends within the thread is written straight to y.  The
// row open at each thread's end is carried by a segmented scan over the
// threads (shuffles in a warp, then the 8 warp totals in order), so a row
// spanning threads is folded in thread order.  Of the window's rows, only
// the one it starts inside (if that row began in an earlier window) and
// the one it ends inside (if that row goes on past the window) are not
// written: they leave carry_head[w] and carry_tail[w], two per window.
// Pass 2, one warp per split row: the row's parts, carry_tail of the
// windows where it begins and continues and carry_head of the window where
// it ends, are folded in window order (lane j takes parts j, j+32, ...,
// then a fixed xor-butterfly), and base ⊕ that is written.  Every row is
// written exactly once, a row with no nonzeros as base ⊕ identity.  No
// atomics, so every run folds in the same order.
//
// Bound on an H100: bytes, 8 nnz (vals, cols) + 4 n_cols (x) + 8 n_rows
// (base, y); the layout adds 4 n_rows of row pointers and 8 bytes per
// window of carries.  x (16 MB at 2^22 rows) stays in the 50 MB L2.
#include <stdint.h>

#include "semiring.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWindow = 4096;
constexpr int kMinBlocks = 6;          // resident CTAs an SM should hold
constexpr unsigned kFull = 0xffffffffu;

template <class SR>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmv_seg_window_kernel(const float* __restrict__ vals,
                       const int* __restrict__ cols,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ win_row,
                       const float* __restrict__ x,
                       const float* __restrict__ base,
                       float* __restrict__ y, float* __restrict__ carry_head,
                       float* __restrict__ carry_tail, long long n_items,
                       int window) {
  extern __shared__ float stage[];  // products, row ends, bases: window each
  float* prod = stage;
  int* rend = reinterpret_cast<int*>(stage + window);  // relative to k0
  float* row_base = stage + 2 * window;
  __shared__ float scan[kThreads];       // inclusive segmented scan
  __shared__ float warp_tot[kWarps], warp_in[kWarps];
  __shared__ int warp_flag[kWarps], began_before;
  const int w = blockIdx.x, t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const long long d0 = (long long)w * window;
  const long long d1 = min(d0 + window, n_items);
  const int i0 = __ldg(win_row + w), i1 = __ldg(win_row + w + 1);
  const int k0 = (int)(d0 - i0), n_i = i1 - i0;
  const int n_k = (int)(d1 - i1) - k0, n = n_i + n_k;
  // staging: the products, and the end and base of each row that ends in
  // the window (rows i0 .. i1 - 1, so the writes below wait on no load)
  for (int k = t; k < n_k; k += kThreads)
    prod[k] = SR::mul(__ldcs(vals + k0 + k), __ldg(x + __ldcs(cols + k0 + k)));
  for (int r = t; r < n_i; r += kThreads) {
    rend[r] = __ldg(row_ptr + i0 + 1 + r) - k0;
    row_base[r] = base != nullptr ? __ldcs(base + i0 + r) : SR::identity();
  }
  if (t == 0) began_before = __ldg(row_ptr + i0) < k0;
  __syncthreads();

  // this thread's items: merge-path search for its first one
  const int ipt = (window + kThreads - 1) / kThreads;
  const int lo = min(t * ipt, n), hi = min(lo + ipt, n);
  int a = max(lo - n_k, 0), b = min(lo, n_i);
  while (a < b) {
    const int p = (a + b) >> 1;
    if (rend[p] <= lo - p - 1) a = p + 1; else b = p;
  }
  const int first = a;                   // row open at the thread's start
  int i = a, k = lo - a;
  float s = SR::identity(), head = SR::identity();
  bool has_end = false;
  for (int q = lo; q < hi; ++q) {
    if (i < n_i && rend[i] <= k) {       // row i0 + i ends here
      if (has_end) {                     // it started in this thread
        y[i0 + i] = base != nullptr ? SR::add(row_base[i], s) : s;
      } else {
        head = s;
        has_end = true;
      }
      s = SR::identity();
      ++i;
    } else {
      s = SR::add(s, prod[k]);
      ++k;
    }
  }

  // segmented inclusive scan of the carry-outs: a segment starts at a
  // thread whose carry-out row began in it (it ended a row) and at t = 0
  float v = s;
  int f = has_end || t == 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float vu = __shfl_up_sync(kFull, v, off);
    const int fu = __shfl_up_sync(kFull, f, off);
    if (lane >= off) {
      if (!f) v = SR::add(vu, v);
      f |= fu;
    }
  }
  if (lane == 31) {
    warp_tot[wid] = v;
    warp_flag[wid] = f;
  }
  __syncthreads();
  if (t == 0) {
    float c = SR::identity();
    for (int j = 0; j < kWarps; ++j) {
      warp_in[j] = c;
      c = warp_flag[j] ? warp_tot[j] : SR::add(c, warp_tot[j]);
    }
  }
  __syncthreads();
  if (!f) v = SR::add(warp_in[wid], v);
  scan[t] = v;
  __syncthreads();

  if (has_end) {                         // the row open at the thread's start
    const float val = SR::add(t > 0 ? scan[t - 1] : SR::identity(), head);
    if (first == 0 && began_before)
      carry_head[w] = val;               // it began in an earlier window
    else
      y[i0 + first] =
          base != nullptr ? SR::add(row_base[first], val) : val;
  }
  if (t == kThreads - 1) carry_tail[w] = v;  // row i1, open past the window
}

template <class SR>
__global__ void spmv_seg_split_kernel(const int* __restrict__ row_ptr,
                                      const int* __restrict__ split_rows,
                                      int n_split,
                                      const float* __restrict__ carry_head,
                                      const float* __restrict__ carry_tail,
                                      const float* __restrict__ base,
                                      float* __restrict__ y, int window) {
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= n_split) return;             // whole warps leave together
  const int row = split_rows[gw];
  const long long wa = ((long long)row_ptr[row] + row) / window;
  const long long wb = ((long long)row_ptr[row + 1] + row) / window;
  const int parts = (int)(wb - wa) + 1;
  float s = SR::identity();
  for (int q = lane; q < parts; q += 32)
    s = SR::add(s, q < parts - 1 ? carry_tail[wa + q] : carry_head[wb]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = SR::add(s, __shfl_xor_sync(kFull, s, off));
  if (lane == 0) y[row] = base != nullptr ? SR::add(base[row], s) : s;
}

// carries: (2, n_win) scratch, heads then tails; base: (n_rows,) or null.
extern "C" int spmv_csr_seg_f32(const void* vals, const void* cols,
                                const void* row_ptr, const void* win_row,
                                const void* split_rows, const void* x,
                                const void* base, void* carries, void* y,
                                long long nnz, int n_rows, int n_win,
                                int n_split, int window, int semiring,
                                void* stream) {
  if (window < 1 || window > kMaxWindow) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* head = (float*)carries;
  float* tail = head + n_win;
  SEMIRING_DISPATCH(semiring, SR,
    if (n_win > 0) {
      const cudaError_t e = cudaFuncSetAttribute(
          spmv_seg_window_kernel<SR>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, 12 * window);
      if (e != cudaSuccess) return (int)e;
      spmv_seg_window_kernel<SR><<<n_win, kThreads, 12 * window, st>>>(
          (const float*)vals, (const int*)cols, (const int*)row_ptr,
          (const int*)win_row, (const float*)x, (const float*)base,
          (float*)y, head, tail, nnz + n_rows, window);
    }
    if (n_split > 0)
      spmv_seg_split_kernel<SR><<<(n_split + kWarps - 1) / kWarps, kThreads,
                                  0, st>>>(
          (const int*)row_ptr, (const int*)split_rows, n_split, head, tail,
          (const float*)base, (float*)y, window);)
  return last_error();
}
