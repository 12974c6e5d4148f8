// Batched segmented (merge-path) CSR SpMM under a semiring for Hopper:
//   Y[c, row] = base[c, row] ⊕ (⊕ over the row's nonzeros of vals ⊗ X[c, cols])
// for every column c < k.
//
// Replaces no pl.pallas_call: it is the card's form of the reference's
// batched path for csr-seg plans and the heavy half of HYB plans,
// repro/plan/plan.py:SpmvPlan.execute_many (the format's jnp kernel
// vmapped over the rows of X, one fused SpMM).  A loop of spmv_csr_seg
// launches reads the stream and gathers x once per vector.
//
// The partition of work is spmv_csr_seg.cu's, unchanged: one CTA per
// merge-path window of `window` items, thread t walks items
// [t*ipt, (t+1)*ipt) of it from the row a merge-path search finds, a
// segmented scan carries the row open at each thread's end (shuffles in a
// warp, then the 8 warp totals in order), two carries per window, and a
// second pass folds each split row's parts in window order (lane j takes
// parts j, j+32, ..., then a fixed xor-butterfly).  So each column folds
// in the order spmv_csr_seg folds it, and Y[c] equals
// spmv_csr_seg(X[c], base[c]) bit for bit.  No atomics.
//
// What changes is what is staged: the window's vals, cols and row ends
// go into shared memory once per CTA (12 * window bytes), for every
// column; the products are formed from them as the threads walk.  X
// comes column-interleaved, Xt (n_cols, k), so one gather brings a tile
// of KC <= 8 columns (one 32-byte sector); each thread keeps KC running
// values and KC row heads, and the scan runs on all KC at once under one
// set of segment flags.  For k > KC the CTA walks the tiles one after
// the other over the same staged window and the same merge-path start:
// the stream and the row pointers are read from device memory once a
// call.  Carries are (2, k, n_win); pass 2 runs one warp per (split row,
// column).
//
// Bound on an H100: bytes -- 8 nnz (vals, cols) + 4 n_rows (row ends)
// once, Xt once (4 k n_cols), base and Y once (8 k n_rows).  At k = 1 x
// (16 MB at 2^22) stays in the 50 MB L2; at k = 64 Xt is 1 GiB, and the
// heavy stream's random gathers come from device memory, one sector per
// nonzero per 8 columns.
#include <stdint.h>

#include "semiring.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWindow = 4096;
constexpr int kMaxTile = 8;
constexpr unsigned kFull = 0xffffffffu;

template <class SR, int KC>
__global__ void __launch_bounds__(kThreads)
spmm_seg_window_kernel(const float* __restrict__ vals,
                       const int* __restrict__ cols,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ win_row,
                       const float* __restrict__ xt,
                       const float* __restrict__ base,
                       float* __restrict__ y, float* __restrict__ carry_head,
                       float* __restrict__ carry_tail, long long n_items,
                       int window, int n_rows, int n_win, int k, bool vec) {
  extern __shared__ float stage[];  // vals, cols, row ends: window each
  float* sval = stage;
  int* scol = reinterpret_cast<int*>(stage + window);
  int* rend = reinterpret_cast<int*>(stage + 2 * window);  // relative to k0
  __shared__ float scan[KC][kThreads];   // inclusive segmented scans
  __shared__ float warp_tot[KC][kWarps], warp_in[KC][kWarps];
  __shared__ int warp_flag[kWarps], began_before;
  const int w = blockIdx.x, t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const long long d0 = (long long)w * window;
  const long long d1 = min(d0 + window, n_items);
  const int i0 = __ldg(win_row + w), i1 = __ldg(win_row + w + 1);
  const int k0 = (int)(d0 - i0), n_i = i1 - i0;
  const int n_k = (int)(d1 - i1) - k0, n = n_i + n_k;
  for (int q = t; q < n_k; q += kThreads) {
    sval[q] = __ldcs(vals + k0 + q);
    scol[q] = __ldcs(cols + k0 + q);
  }
  for (int r = t; r < n_i; r += kThreads)
    rend[r] = __ldg(row_ptr + i0 + 1 + r) - k0;
  if (t == 0) began_before = __ldg(row_ptr + i0) < k0;
  __syncthreads();

  // this thread's items: merge-path search for its first one (once, for
  // every tile)
  const int ipt = (window + kThreads - 1) / kThreads;
  const int lo = min(t * ipt, n), hi = min(lo + ipt, n);
  int a = max(lo - n_k, 0), b = min(lo, n_i);
  while (a < b) {
    const int p = (a + b) >> 1;
    if (rend[p] <= lo - p - 1) a = p + 1; else b = p;
  }
  const int first = a;                   // row open at the thread's start

  for (int c0 = 0; c0 < k; c0 += KC) {
    const int kc = min(KC, k - c0);
    const float* xc = xt + c0;
    const long long yc = (long long)c0 * n_rows;   // column c0's Y row
    int i = first, kk = lo - first;
    float s[KC], head[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) s[c] = head[c] = SR::identity();
    bool has_end = false;
    for (int q = lo; q < hi; ++q) {
      if (i < n_i && rend[i] <= kk) {    // row i0 + i ends here
        if (has_end) {                   // it started in this thread
#pragma unroll
          for (int c = 0; c < KC; ++c)
            if (c < kc) {
              const long long o = yc + (long long)c * n_rows + i0 + i;
              y[o] = base != nullptr ? SR::add(__ldg(base + o), s[c]) : s[c];
            }
        } else {
#pragma unroll
          for (int c = 0; c < KC; ++c) head[c] = s[c];
          has_end = true;
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) s[c] = SR::identity();
        ++i;
      } else {
        float xv[KC];
        gather_tile<KC>(xc + (long long)scol[kk] * k, kc, vec, xv);
        const float v = sval[kk];
#pragma unroll
        for (int c = 0; c < KC; ++c) s[c] = SR::add(s[c], SR::mul(v, xv[c]));
        ++kk;
      }
    }

    // segmented inclusive scan of the carry-outs, every column under the
    // same flags: a segment starts at a thread whose carry-out row began
    // in it (it ended a row) and at t = 0
    float v[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) v[c] = s[c];
    int f = has_end || t == 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      float vu[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) vu[c] = __shfl_up_sync(kFull, v[c], off);
      const int fu = __shfl_up_sync(kFull, f, off);
      if (lane >= off) {
        if (!f) {
#pragma unroll
          for (int c = 0; c < KC; ++c) v[c] = SR::add(vu[c], v[c]);
        }
        f |= fu;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int c = 0; c < KC; ++c) warp_tot[c][wid] = v[c];
      warp_flag[wid] = f;
    }
    __syncthreads();
    if (t < KC) {                        // column c0 + t's warp totals
      float acc = SR::identity();
      for (int j = 0; j < kWarps; ++j) {
        warp_in[t][j] = acc;
        acc = warp_flag[j] ? warp_tot[t][j] : SR::add(acc, warp_tot[t][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      if (!f) v[c] = SR::add(warp_in[c][wid], v[c]);
      scan[c][t] = v[c];
    }
    __syncthreads();

    if (has_end) {                       // the row open at the thread's start
      const bool to_head = first == 0 && began_before;
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < kc) {
          const float val =
              SR::add(t > 0 ? scan[c][t - 1] : SR::identity(), head[c]);
          if (to_head) {                 // it began in an earlier window
            carry_head[(long long)(c0 + c) * n_win + w] = val;
          } else {
            const long long o = yc + (long long)c * n_rows + i0 + first;
            y[o] = base != nullptr ? SR::add(__ldg(base + o), val) : val;
          }
        }
    }
    if (t == kThreads - 1) {             // row i1, open past the window
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < kc) carry_tail[(long long)(c0 + c) * n_win + w] = v[c];
    }
    __syncthreads();                     // the scan arrays serve the next tile
  }
}

template <class SR>
__global__ void spmm_seg_split_kernel(const int* __restrict__ row_ptr,
                                      const int* __restrict__ split_rows,
                                      long long n_pairs,
                                      const float* __restrict__ carry_head,
                                      const float* __restrict__ carry_tail,
                                      const float* __restrict__ base,
                                      float* __restrict__ y, int window,
                                      int n_rows, int n_win, int k) {
  const long long gw =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= n_pairs) return;             // whole warps leave together
  const int row = split_rows[gw / k], c = (int)(gw % k);
  const long long wa = ((long long)row_ptr[row] + row) / window;
  const long long wb = ((long long)row_ptr[row + 1] + row) / window;
  const int parts = (int)(wb - wa) + 1;
  const float* head = carry_head + (long long)c * n_win;
  const float* tail = carry_tail + (long long)c * n_win;
  float s = SR::identity();
  for (int q = lane; q < parts; q += 32)
    s = SR::add(s, q < parts - 1 ? tail[wa + q] : head[wb]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = SR::add(s, __shfl_xor_sync(kFull, s, off));
  if (lane == 0) {
    const long long o = (long long)c * n_rows + row;
    y[o] = base != nullptr ? SR::add(base[o], s) : s;
  }
}

template <class SR, int KC>
int launch_windows(int n_win, int window, cudaStream_t st, const float* vals,
                   const int* cols, const int* row_ptr, const int* win_row,
                   const float* xt, const float* base, float* y, float* head,
                   float* tail, long long n_items, int n_rows, int k,
                   bool vec) {
  const cudaError_t e = cudaFuncSetAttribute(
      spmm_seg_window_kernel<SR, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 12 * window);
  if (e != cudaSuccess) return (int)e;
  spmm_seg_window_kernel<SR, KC><<<n_win, kThreads, 12 * window, st>>>(
      vals, cols, row_ptr, win_row, xt, base, y, head, tail, n_items, window,
      n_rows, n_win, k, vec);
  return 0;
}

template <class SR>
int launch(int kc, int n_win, int n_split, int window, cudaStream_t st,
           const float* vals, const int* cols, const int* row_ptr,
           const int* win_row, const int* split_rows, const float* xt,
           const float* base, float* y, float* head, float* tail,
           long long n_items, int n_rows, int k, bool vec) {
  if (n_win > 0) {
    int rc = 0;
#define SPMM_SEG_CASE(KC)                                                 \
  case KC:                                                                \
    rc = launch_windows<SR, KC>(n_win, window, st, vals, cols, row_ptr,   \
                                win_row, xt, base, y, head, tail,         \
                                n_items, n_rows, k, vec);                 \
    break;
    switch (kc) {
      SPMM_SEG_CASE(1)
      SPMM_SEG_CASE(2)
      SPMM_SEG_CASE(4)
      SPMM_SEG_CASE(8)
    }
#undef SPMM_SEG_CASE
    if (rc != 0) return rc;
  }
  const long long n_pairs = (long long)n_split * k;
  if (n_pairs > 0)
    spmm_seg_split_kernel<SR>
        <<<(unsigned)((n_pairs + kWarps - 1) / kWarps), kThreads, 0, st>>>(
            row_ptr, split_rows, n_pairs, head, tail, base, y, window,
            n_rows, n_win, k);
  return 0;
}

}  // namespace

// xt: (n_cols, k) column-interleaved X; base: (k, n_rows) or null;
// carries: (2, k, n_win) scratch, heads then tails; y: (k, n_rows).
extern "C" int spmm_csr_seg_f32(const void* vals, const void* cols,
                                const void* row_ptr, const void* win_row,
                                const void* split_rows, const void* xt,
                                const void* base, void* carries, void* y,
                                long long nnz, int n_rows, int n_win,
                                int n_split, int window, int k, int semiring,
                                void* stream) {
  if (window < 1 || window > kMaxWindow || k < 1)
    return (int)cudaErrorInvalidValue;
  float* head = (float*)carries;
  float* tail = head + (long long)k * n_win;
  const bool vec = k % 4 == 0 && ((uintptr_t)xt & 15) == 0;
  const int kc = column_tile(k, kMaxTile);
  int rc = 0;
  SEMIRING_DISPATCH(semiring, SR,
    rc = launch<SR>(kc, n_win, n_split, window, (cudaStream_t)stream,
                    (const float*)vals, (const int*)cols,
                    (const int*)row_ptr, (const int*)win_row,
                    (const int*)split_rows, (const float*)xt,
                    (const float*)base, (float*)y, head, tail,
                    nnz + n_rows, n_rows, k, vec))
  if (rc != 0) return rc;
  return last_error();
}
