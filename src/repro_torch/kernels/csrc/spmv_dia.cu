// Banded (DIA) SpMV for Hopper: y[i] = Σ_k band[k, i] * x[i + off[k]].
//
// Replaces the TPU kernel repro/kernels/spmv_dia.py:spmv_dia_pallas (body
// _kernel), reached through repro/kernels/_layout.py:spmv_dia_prepared.
// The TPU version walks (row block x diagonal) with scalar-prefetched
// offsets and reads every x window from a zero-haloed copy of x as two
// aligned blocks.  Here one thread owns one output row and loops over the
// diagonals in the reference's order; x is read at i + off[k] under a
// bounds mask (zero outside [0, n_cols)), so no halo copy is made.
//
// Bound on an H100: bytes.  It must read the band (4 D n), x (4 n) and write
// y (4 n): about 0.9 flop per byte, far below the card's balance point.
// Neighbouring threads read neighbouring band entries and neighbouring x
// entries for every diagonal, so each warp's loads are fully coalesced and
// the x window of a diagonal is served from L1/L2 for the next one.
#include "semiring.cuh"

__global__ void spmv_dia_kernel(const float* __restrict__ band,
                                const int* __restrict__ offsets,
                                const float* __restrict__ x,
                                float* __restrict__ y,
                                int n_rows, int n_cols, int n_diags) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  float acc = 0.0f;
  for (int k = 0; k < n_diags; ++k) {
    long long j = (long long)i + __ldg(offsets + k);
    float xv = (j >= 0 && j < n_cols) ? __ldg(x + j) : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(__ldg(band + (long long)k * n_rows + i), xv));
  }
  y[i] = acc;
}

extern "C" int spmv_dia_f32(const void* band, const void* offsets,
                            const void* x, void* y, int n_rows, int n_cols,
                            int n_diags, void* stream) {
  const int threads = 256;
  int blocks = (n_rows + threads - 1) / threads;
  spmv_dia_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)band, (const int*)offsets, (const float*)x, (float*)y,
      n_rows, n_cols, n_diags);
  return last_error();
}
