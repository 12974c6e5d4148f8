// The column tile of the batched (SpMM) kernels of repro_torch.
//
// A batched kernel reads X column-interleaved, Xt (n_cols, k) row-major,
// so the k values of one gathered column index lie side by side, and it
// folds KC columns at a time into KC accumulators.  `gather_tile` loads
// the `kc` <= KC values of one tile: as 16-byte loads when `vec` says
// that every tile starts on a 16-byte boundary (k % 4 == 0 and Xt
// aligned), else one by one.  Lanes at or past kc are left at 0 and are
// never stored.
#pragma once

#include "common.cuh"

template <int KC>
__device__ __forceinline__ void gather_tile(const float* __restrict__ p,
                                            int kc, bool vec,
                                            float (&v)[KC]) {
#pragma unroll
  for (int c = 0; c < KC; ++c) v[c] = 0.0f;
  if constexpr (KC >= 4) {
    if (vec) {
#pragma unroll
      for (int c = 0; c < KC; c += 4)
        if (c < kc) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(p + c));
          v[c] = q.x;
          v[c + 1] = q.y;
          v[c + 2] = q.z;
          v[c + 3] = q.w;
        }
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < KC; ++c)
    if (c < kc) v[c] = __ldg(p + c);
}

// The tile a batch of k columns is cut into: the smallest of 1, 2, 4, 8,
// ... kMax that holds k, or kMax when k is larger.
static inline int column_tile(int k, int kmax) {
  int kc = 1;
  while (kc < k && kc < kmax) kc <<= 1;
  return kc;
}
