// Batched ELLPACK SpMM under a semiring for Hopper:
//   Y[c, r] = ⊕_w data[w, r] ⊗ X[c, idx[w, r]]   for every column c < k.
//
// Replaces no pl.pallas_call: it is the card's form of the reference's
// batched path for ELL (and HYB light) plans, repro/plan/plan.py:
// SpmvPlan.execute_many, which vmaps the format's jnp kernel over the
// rows of X and jits it once per plan -- one fused SpMM, where a loop of
// spmv_ell launches reads the layout and gathers x once per vector.
//
// One thread owns one row, as in spmv_ell_kernel, and keeps KC
// accumulators, a tile of KC <= 16 columns.  It walks the slots
// w = 0 .. W-1 in order; for each slot it reads data[w, r] and
// idx[w, r] (coalesced over the warp) and folds the slot into every
// column of the tile.  X comes column-interleaved, Xt (n_cols, k), the
// wrapper's copy: the tile's values of one gathered row lie side by
// side, so one 32-byte sector serves 8 columns.  Y is (k, n_rows): the
// warp's 32 rows of one column are one coalesced store.  For k > KC the
// thread walks the tiles one after the other; the later tiles re-read
// its slots, which the CTA has just read (8 W x 256 bytes), from L1 or
// L2, so device memory streams the layout once a call.
//
// Each column folds exactly as spmv_ell_kernel does: from the identity,
// slot by slot, one rounded ⊗ and one rounded ⊕ at a time (no FMA), so
// Y[c] equals spmv_ell(X[c]) bit for bit.  No atomics.
//
// Bound on an H100: bytes -- the layout once (8 W n_rows), Xt once
// (4 k n_cols) and Y once (4 k n_rows).  At k = 64 and 2^22 rows Xt is
// 1 GiB and no longer fits the 50 MB L2: the gathers then come from
// device memory unless the matrix keeps its columns near its rows.
#include <stdint.h>

#include "semiring.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 16;

template <class SR, int KC>
__global__ void __launch_bounds__(kThreads)
spmm_ell_kernel(const float* __restrict__ data, const int* __restrict__ idx,
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
void launch(int kc, int blocks, cudaStream_t st, const float* data,
            const int* idx, const float* xt, float* y, int n_rows, int width,
            int k, bool vec) {
#define SPMM_ELL_CASE(KC)                                               \
  case KC:                                                              \
    spmm_ell_kernel<SR, KC><<<blocks, kThreads, 0, st>>>(               \
        data, idx, xt, y, n_rows, width, k, vec);                       \
    break;
  switch (kc) {
    SPMM_ELL_CASE(1)
    SPMM_ELL_CASE(2)
    SPMM_ELL_CASE(4)
    SPMM_ELL_CASE(8)
    SPMM_ELL_CASE(16)
  }
#undef SPMM_ELL_CASE
}

}  // namespace

// xt: (n_cols, k) column-interleaved X; y: (k, n_rows).
extern "C" int spmm_ell_f32(const void* data, const void* idx, const void* xt,
                            void* y, int n_rows, int width, int k,
                            int semiring, void* stream) {
  if (k < 1 || n_rows < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  const bool vec = k % 4 == 0 && ((uintptr_t)xt & 15) == 0;
  const int kc = column_tile(k, kMaxTile);
  SEMIRING_DISPATCH(semiring, SR,
    launch<SR>(kc, blocks, (cudaStream_t)stream, (const float*)data,
               (const int*)idx, (const float*)xt, (float*)y, n_rows, width,
               k, vec))
  return last_error();
}
