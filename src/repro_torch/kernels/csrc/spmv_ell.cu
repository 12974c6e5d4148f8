// ELLPACK SpMV under a semiring for Hopper: y[r] = ⊕_w data[w, r] ⊗ x[idx[w, r]].
//
// Replaces the TPU kernel repro/kernels/spmv_ell.py:spmv_ell_pallas (body
// _kernel), reached through repro/kernels/_layout.py:spmv_ell_prepared.
// The TPU version works on (B, bm, W) row blocks with the width padded to
// 128 lanes and all of x pinned in VMEM.  Here the layout is slot-major
// (W, n_rows) with no width padding: one thread owns one row, and for each
// slot w the 32 threads of a warp read 32 neighbouring entries of data and
// idx, a fully coalesced load.  The semiring is a template parameter;
// padding slots hold its absorbing value and fold in like any slot.
//
// Bound on an H100: bytes.  It must read data and idx (8 W n), x (4 n) and
// write y (4 n); the x gathers are random for power-law rows and rely on
// the 50 MB L2 to hold x (16 MB at 2^22 rows).
#include "semiring.cuh"

template <class SR>
__global__ void spmv_ell_kernel(const float* __restrict__ data,
                                const int* __restrict__ idx,
                                const float* __restrict__ x,
                                float* __restrict__ y,
                                int n_rows, int width) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  float acc = SR::identity();
  for (int w = 0; w < width; ++w) {
    long long p = (long long)w * n_rows + r;
    acc = SR::add(acc, SR::mul(__ldg(data + p), __ldg(x + __ldg(idx + p))));
  }
  y[r] = acc;
}

extern "C" int spmv_ell_f32(const void* data, const void* idx, const void* x,
                            void* y, int n_rows, int width, int semiring,
                            void* stream) {
  const int threads = 256;
  int blocks = (n_rows + threads - 1) / threads;
  SEMIRING_DISPATCH(semiring, SR,
    spmv_ell_kernel<SR><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)data, (const int*)idx, (const float*)x, (float*)y,
        n_rows, width))
  return last_error();
}
