// Batched ELLPACK SpMM under a semiring for Hopper:
//   Y[c, r] = ⊕_w data[w, r] ⊗ X[c, idx[w, r]]   for every column c < k.
//
// Replaces no pl.pallas_call: it is the card's form of the reference's
// batched path for ELL (and HYB light) plans, repro/plan/plan.py:
// SpmvPlan.execute_many, which vmaps the format's jnp kernel over the
// rows of X and jits it once per plan -- one fused SpMM, where a loop of
// spmv_ell launches reads the layout and gathers x once per vector.
//
// Two kernels; the wrapper picks one per slab, on the host, from how the
// slab's rows gather (`spmv_ell.gather_layout`):
//
//  * `spmm_ell_direct_kernel`, for banded slabs -- neighbouring rows gather
//    neighbouring columns in a slot, as FD's stencil and an RCM'd band do.
//    X is read as it lies, (k, n_cols), and no interleaved copy of X is
//    made.  One thread a row walks the slots and, per slot, reads
//    X[c, idx[w, r]] for a tile of KC = 4 columns, so a warp's 32 rows read
//    one or two 128-byte lines of each column per slot, and the stencil's
//    neighbouring slots find those lines in L1: a warp keeps 4 columns'
//    lines live, not 16 (tiles of 16 ran 1.44-1.57x slower at k = 16-64,
//    and walking the columns outside the slots 1.05-1.30x; PERF.md §6,
//    A/B).  The thread walks the tiles one after the other, re-reading its
//    slots from L1.
//  * `spmm_ell_xt_kernel`, for random slabs (R-MAT's light rows).  X comes
//    column-interleaved, Xt (n_cols, k), the copy the HYB heavy stream
//    gathers from too: the tile's values of one gathered row lie side by
//    side, so one 32-byte sector serves 8 columns.  One thread a row keeps
//    KC <= 16 accumulators and walks the slots in order, folding each slot
//    into every column of the tile; for k > KC it walks the tiles one after
//    the other, re-reading its slots from L1 or L2.  Lane groups that share
//    a row and gather whole Xt rows (as `spmm_csr_seg` does) ran 1.09-1.36x
//    slower here at k = 16-64 (PERF.md §6, A/B): R-MAT's light slab is
//    mostly padding, whose gathers all hit one cached row, so rows in
//    flight count for more than whole-row requests.
//
// Each column folds exactly as spmv_ell_kernel does: from the identity,
// slot by slot, one rounded ⊗ and one rounded ⊕ at a time (no FMA), so
// Y[c] equals spmv_ell(X[c]) bit for bit whichever kernel runs.  No
// atomics.
//
// Bound on an H100: bytes -- the layout once (8 W n_rows), X once
// (4 k n_cols) and Y once (4 k n_rows).  At k = 64 and 2^22 rows X is
// 1 GiB and no longer fits the 50 MB L2; the direct kernel's reuse of a
// line across neighbouring rows and slots then comes from L1 and L2 while
// the rows that share it are in flight.
#include <stdint.h>

#include "semiring.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 4;     // direct kernel's columns a tile
constexpr int kMaxXtTile = 16;  // Xt kernel's columns a tile

template <class SR, int KC>
__global__ void __launch_bounds__(kThreads)
spmm_ell_direct_kernel(const float* __restrict__ data,
                       const int* __restrict__ idx,
                       const float* __restrict__ x, float* __restrict__ y,
                       int n_rows, int n_cols, int width, int k) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  for (int c0 = 0; c0 < k; c0 += KC) {
    const int kc = min(KC, k - c0);
    const float* xc = x + (long long)c0 * n_cols;
    float acc[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] = SR::identity();
    for (int w = 0; w < width; ++w) {
      const long long p = (long long)w * n_rows + r;
      const float d = __ldg(data + p);
      const float* xj = xc + __ldg(idx + p);
#pragma unroll
      for (int c = 0; c < KC; ++c)
        if (c < kc)
          acc[c] = SR::add(acc[c],
                           SR::mul(d, __ldg(xj + (long long)c * n_cols)));
    }
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c < kc) y[(long long)(c0 + c) * n_rows + r] = acc[c];
  }
}

template <class SR, int KC>
__global__ void __launch_bounds__(kThreads)
spmm_ell_xt_kernel(const float* __restrict__ data,
                   const int* __restrict__ idx,
                   const float* __restrict__ xt, float* __restrict__ y,
                   int n_rows, int width, int k, bool vec) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  for (int c0 = 0; c0 < k; c0 += KC) {
    const int kc = min(KC, k - c0);
    float acc[KC];
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[c] = SR::identity();
    for (int w = 0; w < width; ++w) {
      const long long p = (long long)w * n_rows + r;
      const float d = __ldg(data + p);
      float xv[KC];
      gather_tile<KC>(xt + (long long)__ldg(idx + p) * k + c0, kc, vec, xv);
#pragma unroll
      for (int c = 0; c < KC; ++c) acc[c] = SR::add(acc[c], SR::mul(d, xv[c]));
    }
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c < kc) y[(long long)(c0 + c) * n_rows + r] = acc[c];
  }
}

template <class SR>
void launch_direct(int kc, cudaStream_t st, const float* data,
                   const int* idx, const float* x, float* y, int n_rows,
                   int n_cols, int width, int k) {
  const int blocks = (n_rows + kThreads - 1) / kThreads;
#define SPMM_ELL_DIRECT(KC)                                             \
  case KC:                                                              \
    spmm_ell_direct_kernel<SR, KC><<<blocks, kThreads, 0, st>>>(        \
        data, idx, x, y, n_rows, n_cols, width, k);                     \
    break;
  switch (kc) {
    SPMM_ELL_DIRECT(1)
    SPMM_ELL_DIRECT(2)
    SPMM_ELL_DIRECT(4)
  }
#undef SPMM_ELL_DIRECT
}

template <class SR>
void launch_xt(int kc, cudaStream_t st, const float* data, const int* idx,
               const float* xt, float* y, int n_rows, int width, int k,
               bool vec) {
  const int blocks = (n_rows + kThreads - 1) / kThreads;
#define SPMM_ELL_XT(KC)                                                 \
  case KC:                                                              \
    spmm_ell_xt_kernel<SR, KC><<<blocks, kThreads, 0, st>>>(            \
        data, idx, xt, y, n_rows, width, k, vec);                       \
    break;
  switch (kc) {
    SPMM_ELL_XT(1)
    SPMM_ELL_XT(2)
    SPMM_ELL_XT(4)
    SPMM_ELL_XT(8)
    SPMM_ELL_XT(16)
  }
#undef SPMM_ELL_XT
}

}  // namespace

// direct != 0: x is X as it lies, (k, n_cols); else its column-interleaved
// copy Xt, (n_cols, k).  y: (k, n_rows).
extern "C" int spmm_ell_f32(const void* data, const void* idx, const void* x,
                            void* y, int n_rows, int n_cols, int width, int k,
                            int direct, int semiring, void* stream) {
  if (k < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (direct) {
    const int kc = column_tile(k, kMaxTile);
    SEMIRING_DISPATCH(semiring, SR,
      launch_direct<SR>(kc, st, (const float*)data, (const int*)idx,
                        (const float*)x, (float*)y, n_rows, n_cols, width,
                        k))
  } else {
    const bool vec = k % 4 == 0 && ((uintptr_t)x & 15) == 0;
    SEMIRING_DISPATCH(semiring, SR,
      launch_xt<SR>(column_tile(k, kMaxXtTile), st, (const float*)data,
                    (const int*)idx, (const float*)x, (float*)y, n_rows,
                    width, k, vec))
  }
  return last_error();
}
