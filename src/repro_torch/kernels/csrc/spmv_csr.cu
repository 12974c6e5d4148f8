// Column-striped padded-CSR SpMV under a semiring for Hopper.
//
// Replaces the TPU kernel repro/kernels/spmv_csr.py:spmv_csr_pallas (body
// _kernel) and the ⊕ over stripes in repro/kernels/_layout.py:
// spmv_csr_prepared.  The layout keeps the reference's cells: the nonzeros
// of stripe s and row block b sit in cell (s, b) of a (S, B, W) array,
// padded to the widest cell with the semiring's absorbing value, in CSR
// (row-major) order.  The TPU kernel reduced a cell by row with a one-hot
// matmul because the TPU has no scatter; here one block owns one cell, one
// thread owns one row of it and walks that row's contiguous run of slots,
// given by rowptr[s, b, r] .. rowptr[s, b, r + 1].  A row's partial for
// stripe s goes to partials[s, row]; a second pass folds the stripes in
// order s = 0 .. S-1.  With one stripe the first pass writes y directly.
// No atomics anywhere, so every run sums in the same order.
//
// Bound on an H100: bytes.  It must read vals and cols (8 nnz), the row
// pointers and x (about 4 n each) and write y (4 n).  The threads of a warp
// walk 32 neighbouring rows, so their slot loads fall in a few neighbouring
// cache lines that the following iterations reuse from L1.
#include "semiring.cuh"

template <class SR>
__global__ void spmv_csr_cells_kernel(const float* __restrict__ vals,
                                      const int* __restrict__ cols,
                                      const int* __restrict__ rowptr,
                                      const float* __restrict__ x,
                                      float* __restrict__ out,
                                      int n_rows, int n_blocks, int width,
                                      int bm) {
  int b = blockIdx.x, s = blockIdx.y, r = threadIdx.x;
  int row = b * bm + r;
  if (row >= n_rows) return;
  long long cell = (long long)s * n_blocks + b;
  const int* ptr = rowptr + cell * (bm + 1);
  long long base = cell * width;
  float acc = SR::identity();
  for (int k = __ldg(ptr + r), end = __ldg(ptr + r + 1); k < end; ++k) {
    acc = SR::add(acc, SR::mul(__ldg(vals + base + k),
                               __ldg(x + __ldg(cols + base + k))));
  }
  out[(long long)s * n_rows + row] = acc;
}

template <class SR>
__global__ void spmv_csr_stripes_kernel(const float* __restrict__ partials,
                                        float* __restrict__ y, int n_rows,
                                        int n_stripes) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  float acc = partials[row];
  for (int s = 1; s < n_stripes; ++s)
    acc = SR::add(acc, partials[(long long)s * n_rows + row]);
  y[row] = acc;
}

// partials: (n_stripes, n_rows) scratch, unused when n_stripes == 1.
extern "C" int spmv_csr_f32(const void* vals, const void* cols,
                            const void* rowptr, const void* x,
                            void* partials, void* y, int n_rows,
                            int n_stripes, int n_blocks, int width, int bm,
                            int semiring, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(n_blocks, n_stripes);
  float* out = n_stripes == 1 ? (float*)y : (float*)partials;
  SEMIRING_DISPATCH(semiring, SR,
    spmv_csr_cells_kernel<SR><<<grid, bm, 0, st>>>(
        (const float*)vals, (const int*)cols, (const int*)rowptr,
        (const float*)x, out, n_rows, n_blocks, width, bm);
    if (n_stripes > 1) {
      const int threads = 256;
      spmv_csr_stripes_kernel<SR><<<(n_rows + threads - 1) / threads,
                                    threads, 0, st>>>(
          (const float*)partials, (float*)y, n_rows, n_stripes);
    })
  return last_error();
}
