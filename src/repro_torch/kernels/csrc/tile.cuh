// The column tiles of the batched (SpMM) kernels of repro_torch.
//
// A batched kernel that gathers reads X column-interleaved, Xt (n_cols, k)
// row-major, so the k values of one gathered column index lie side by
// side.  Two shapes of tile:
//
//  * `gather_tile` (one thread, KC columns): loads the `kc` <= KC values of
//    one tile, as 16-byte loads when `vec` says that every tile starts on a
//    16-byte boundary (k % 4 == 0 and Xt aligned), else one by one.  Lanes
//    at or past kc are left at 0 and are never stored.
//  * `gather_quad` (a group of lanes, four columns a lane): lane l of a
//    group loads columns 4l .. 4l + 3 of the tile, so the group's loads of
//    one gathered row are one coalesced request.  `quad_slot` places a
//    lane's quad in a (rows, G) buffer of float4 in shared memory so that
//    reading one quad down 8 consecutive rows hits 8 different 16-byte
//    bank groups; `fold4` and `add4` are the semiring on a quad, one
//    rounded op per column, in the order the single-vector kernels use.
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

// Columns c .. c + 3 of a gathered row `p` (the tile's first column);
// columns at or past kc are 0.  With `vec`, kc is a multiple of 4.
__device__ __forceinline__ float4 gather_quad(const float* __restrict__ p,
                                              int c, int kc, bool vec) {
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec) {
    if (c < kc) q = __ldg(reinterpret_cast<const float4*>(p + c));
    return q;
  }
  if (c < kc) q.x = __ldg(p + c);
  if (c + 1 < kc) q.y = __ldg(p + c + 1);
  if (c + 2 < kc) q.z = __ldg(p + c + 2);
  if (c + 3 < kc) q.w = __ldg(p + c + 3);
  return q;
}

__device__ __forceinline__ float4 splat(float v) {
  return make_float4(v, v, v, v);
}

template <class SR>
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(SR::add(a.x, b.x), SR::add(a.y, b.y),
                     SR::add(a.z, b.z), SR::add(a.w, b.w));
}

// s ⊕ (v ⊗ x), column by column
template <class SR>
__device__ __forceinline__ float4 fold4(float4 s, float v, float4 x) {
  return make_float4(SR::add(s.x, SR::mul(v, x.x)),
                     SR::add(s.y, SR::mul(v, x.y)),
                     SR::add(s.z, SR::mul(v, x.z)),
                     SR::add(s.w, SR::mul(v, x.w)));
}

// The slot of quad q of row r in a (rows, G) float4 buffer: q xor-ed with
// the bits of r above the rows that share one 128-byte line.
template <int G>
__device__ __forceinline__ int quad_slot(int r, int q) {
  constexpr int kRowsPerLine = G >= 8 ? 1 : 8 / G;
  constexpr int kMask = (G >= 8 ? 8 : G) - 1;
  return r * G + (q ^ ((r / kRowsPerLine) & kMask));
}

// Column j (0..3) of a quad.
__device__ __forceinline__ float quad_at(const float4& q, int j) {
  return j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z : q.w;
}

// The tile a batch of k columns is cut into: the smallest of 1, 2, 4, 8,
// ... kMax that holds k, or kMax when k is larger.
static inline int column_tile(int k, int kmax) {
  int kc = 1;
  while (kc < k && kc < kmax) kc <<= 1;
  return kc;
}
