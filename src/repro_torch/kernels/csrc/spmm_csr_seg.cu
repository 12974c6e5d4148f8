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
// The fold is spmv_csr_seg.cu's, unchanged: one CTA per merge-path window
// of `window` items; 256 *virtual* threads a window, virtual thread t
// walking items [t*ipt, (t+1)*ipt) in order from the row a merge-path
// search finds; within each group of 32 virtual threads a Kogge-Stone
// segmented scan (offsets 1, 2, 4, 8, 16) carries the row open at each
// one's end; the 8 group totals are folded in order; two carries per
// window; and a second pass folds each split row's parts in window order
// (lane j takes parts j, j+32, ..., then a fixed xor-butterfly).  So each
// column folds in the order spmv_csr_seg folds it, and Y[c] equals
// spmv_csr_seg(X[c], base[c]) bit for bit.  No atomics.  None of this
// says which physical lane performs an ⊕, and that is what the two
// window kernels choose differently.  X comes column-interleaved, Xt
// (n_cols, k), and the window's vals, cols and row ends are staged in
// shared memory once, for every column.
//
//  * k <= 4, `spmm_seg_window_kernel`: one physical thread per virtual
//    thread, KC <= 4 running values each; one 16-byte gather a nonzero;
//    the scan in shuffles.
//  * k > 4, `spmm_seg_lanes_kernel`: lanes own columns.  A group of
//    G = min(ceil(k/4), 16) lanes walks one virtual thread's items, lane l
//    holding columns 4l .. 4l+3 of a tile of 4G as one float4, so one
//    nonzero's Xt row (4G columns, 256 bytes at k >= 64) arrives as one
//    coalesced request, once per call -- a design of 8-column tiles
//    fetched one 32-byte sector of it per pass over the window, eight
//    passes at k = 64, each after the row had left L2.  Each lane issues
//    the gathers of up to kDepth of its virtual thread's nonzeros before
//    it folds them, so several rows are in flight per group (a cp.async
//    ring in shared memory instead, at one CTA an SM, ran 1.55-1.62x
//    slower at k = 16-64; PERF.md §6, A/B).  The 512
//    threads hold 512/G virtual threads at a time (a chunk, 32P of them
//    for P = 16/G scan groups); the chunk's carry-outs and heads go to
//    shared memory, where one warp per (scan group, quad) runs the
//    Kogge-Stone scan with the same pairings, and the group totals are
//    folded in order across chunks.  Rows finished in a chunk (at most
//    ipt per virtual thread) are kept in shared memory and stored after
//    it, column by column in runs of consecutive rows, each joined with
//    base there: coalesced stores and base loads, not one 4-byte access
//    per line.  For k > 64, tiles of 64 columns repeat over the staged
//    window.
//
// Carries are (2, n_win, k), a window's columns side by side; pass 2 runs
// one warp per split row, a lane per column (`spmm_seg_split_kernel`).
//
// Bound on an H100: bytes -- 8 nnz (vals, cols) + 4 n_rows (row ends)
// once, Xt once (4 k n_cols), base and Y once (8 k n_rows).  At k = 1 x
// (16 MB at 2^22) stays in the 50 MB L2; at k = 64 Xt is 1 GiB, and the
// heavy stream's gathers come from device memory: reading each gathered
// row once is 8 nnz + 4 k nnz + 8 k n_rows bytes, the gather bound.
#include <stdint.h>

#include "semiring.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 256;          // virtual threads a window
constexpr int kWarps = kThreads / 32;  // their scan groups
constexpr int kMaxWindow = 4096;
constexpr int kMaxTile = 4;            // columns kernel: k <= 4
constexpr int kLanes = 512;            // threads of the lanes kernel
constexpr int kMaxGroup = 16;          // lanes a virtual thread
// gathers a lane issues before it folds them: 4 rows of 256 bytes at
// G = 16, 2 of at most 128 below (deeper spills at the 64 registers two
// CTAs an SM leave a thread)
template <int G> constexpr int kDepth = G >= 8 ? 4 : 2;
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
                       int window, int n_rows, int k, bool vec) {
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

  // this thread's items: merge-path search for its first one
  const int ipt = (window + kThreads - 1) / kThreads;
  const int lo = min(t * ipt, n), hi = min(lo + ipt, n);
  int a = max(lo - n_k, 0), b = min(lo, n_i);
  while (a < b) {
    const int p = (a + b) >> 1;
    if (rend[p] <= lo - p - 1) a = p + 1; else b = p;
  }
  const int first = a;                   // row open at the thread's start

  int i = first, kk = lo - first;
  float s[KC], head[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) s[c] = head[c] = SR::identity();
  bool has_end = false;
  for (int q = lo; q < hi; ++q) {
    if (i < n_i && rend[i] <= kk) {      // row i0 + i ends here
      if (has_end) {                     // it started in this thread
#pragma unroll
        for (int c = 0; c < KC; ++c)
          if (c < k) {
            const long long o = (long long)c * n_rows + i0 + i;
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
      gather_tile<KC>(xt + (long long)scol[kk] * k, k, vec, xv);
      const float v = sval[kk];
#pragma unroll
      for (int c = 0; c < KC; ++c) s[c] = SR::add(s[c], SR::mul(v, xv[c]));
      ++kk;
    }
  }

  // segmented inclusive scan of the carry-outs, every column under the
  // same flags: a segment starts at a thread whose carry-out row began in
  // it (it ended a row) and at t = 0
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
  if (t < KC) {                          // column t's warp totals
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

  if (has_end) {                         // the row open at the thread's start
    const bool to_head = first == 0 && began_before;
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c < k) {
        const float val =
            SR::add(t > 0 ? scan[c][t - 1] : SR::identity(), head[c]);
        if (to_head) {                   // it began in an earlier window
          carry_head[(long long)w * k + c] = val;
        } else {
          const long long o = (long long)c * n_rows + i0 + first;
          y[o] = base != nullptr ? SR::add(__ldg(base + o), val) : val;
        }
      }
  }
  if (t == kThreads - 1) {               // row i1, open past the window
#pragma unroll
    for (int c = 0; c < KC; ++c)
      if (c < k) carry_tail[(long long)w * k + c] = v[c];
  }
}

template <class SR, int G>
__global__ void __launch_bounds__(kLanes, 2)
spmm_seg_lanes_kernel(const float* __restrict__ vals,
                      const int* __restrict__ cols,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ win_row,
                      const float* __restrict__ xt,
                      const float* __restrict__ base,
                      float* __restrict__ y, float* __restrict__ carry_head,
                      float* __restrict__ carry_tail, long long n_items,
                      int window, int n_rows, int k, bool vec) {
  constexpr int CV = kLanes / G;         // virtual threads a chunk
  constexpr int P = CV / 32;             // scan groups a chunk
  constexpr int NC = 4 * G;              // columns a tile
  const int ipt = (window + kThreads - 1) / kThreads;
  extern __shared__ float4 dyn[];
  float4* ybuf = dyn;                    // rows ending in the chunk, (CV ipt, G)
  float4* sbuf = ybuf + CV * ipt * G;    // carry-outs, then the scan, (CV, G)
  float4* hbuf = sbuf + CV * G;          // heads, (CV, G)
  float* sval = reinterpret_cast<float*>(hbuf + CV * G);
  int* scol = reinterpret_cast<int*>(sval + window);
  int* rend = scol + window;             // relative to k0
  __shared__ int vfirst[kThreads + 1];   // each virtual thread's first row
  __shared__ int vend[CV];               // it ended a row (in this chunk)
  __shared__ float tot[P][NC], tin[P][NC];
  __shared__ int tflag[P];
  __shared__ float4 last[G];             // the previous chunk's last scan
  __shared__ int began_before;
  const int w = blockIdx.x, t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const long long d0 = (long long)w * window;
  const long long d1 = min(d0 + window, n_items);
  const int i0 = __ldg(win_row + w), i1 = __ldg(win_row + w + 1);
  const int k0 = (int)(d0 - i0), n_i = i1 - i0;
  const int n_k = (int)(d1 - i1) - k0, n = n_i + n_k;
  for (int q = t; q < n_k; q += kLanes) {
    sval[q] = __ldcs(vals + k0 + q);
    scol[q] = __ldcs(cols + k0 + q);
  }
  for (int r = t; r < n_i; r += kLanes)
    rend[r] = __ldg(row_ptr + i0 + 1 + r) - k0;
  if (t == 0) began_before = __ldg(row_ptr + i0) < k0;
  __syncthreads();
  // merge-path search for each virtual thread's first row (and, as
  // virtual thread 256, the window's end)
  for (int v = t; v <= kThreads; v += kLanes) {
    const int lo = min(v * ipt, n);
    int a = max(lo - n_k, 0), b = min(lo, n_i);
    while (a < b) {
      const int p = (a + b) >> 1;
      if (rend[p] <= lo - p - 1) a = p + 1; else b = p;
    }
    vfirst[v] = a;
  }
  __syncthreads();

  const int g = t / G, l = t % G;        // fold: virtual thread, lane
  const int sp = wid / G, sq = wid % G;  // scan: group of the chunk, quad
  const int sv = sp * 32 + lane;         // scan: virtual thread of the chunk
  for (int c0 = 0; c0 < k; c0 += NC) {
    const int kc = min(NC, k - c0);
    const float* xc = xt + c0;
    float acc = SR::identity();          // t < NC: column c0 + t's totals
    for (int v0 = 0; v0 < kThreads; v0 += CV) {
      const int rb = vfirst[v0];         // rows rb .. re - 1 end in the chunk
      {
        // fold: virtual thread v0 + g walks its items; its nonzeros are
        // kk .. kend - 1 and its row ends those of rows first .. fnext - 1,
        // a row end coming before nonzero kk when rend <= kk
        const int v = v0 + g;
        const int fnext = vfirst[v + 1];
        const int lo = min(v * ipt, n), hi = min(lo + ipt, n);
        int i = vfirst[v], kk = lo - i;
        const int kend = hi - fnext;
        float4 s = splat(SR::identity()), head = s;
        bool has_end = false;
        auto close_rows = [&]() {
          for (; i < fnext && rend[i] <= kk; ++i) {
            if (has_end) {
              ybuf[quad_slot<G>(i - rb, l)] = s;   // it started here
            } else {
              head = s;
              has_end = true;
            }
            s = splat(SR::identity());
          }
        };
        while (kk < kend) {
          const int nb = min(kDepth<G>, kend - kk);
          float4 xv[kDepth<G>];
#pragma unroll
          for (int j = 0; j < kDepth<G>; ++j)
            if (j < nb)
              xv[j] = gather_quad(xc + (long long)scol[kk + j] * k, 4 * l,
                                  kc, vec);
#pragma unroll
          for (int j = 0; j < kDepth<G>; ++j)
            if (j < nb) {
              close_rows();
              s = fold4<SR>(s, sval[kk], xv[j]);
              ++kk;
            }
        }
        close_rows();
        sbuf[quad_slot<G>(g, l)] = s;
        hbuf[quad_slot<G>(g, l)] = head;
        if (l == 0) vend[g] = has_end;
      }
      __syncthreads();

      // segmented inclusive scan within each group of 32 virtual threads:
      // a segment starts at one that ended a row and at virtual thread 0
      float4 sc = sbuf[quad_slot<G>(sv, sq)];
      int f = vend[sv] || v0 + sv == 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        float4 u;
        u.x = __shfl_up_sync(kFull, sc.x, off);
        u.y = __shfl_up_sync(kFull, sc.y, off);
        u.z = __shfl_up_sync(kFull, sc.z, off);
        u.w = __shfl_up_sync(kFull, sc.w, off);
        const int fu = __shfl_up_sync(kFull, f, off);
        if (lane >= off) {
          if (!f) sc = add4<SR>(u, sc);
          f |= fu;
        }
      }
      if (lane == 31) {
        tot[sp][4 * sq] = sc.x;
        tot[sp][4 * sq + 1] = sc.y;
        tot[sp][4 * sq + 2] = sc.z;
        tot[sp][4 * sq + 3] = sc.w;
        if (sq == 0) tflag[sp] = f;
      }
      __syncthreads();
      if (t < NC) {                      // the group totals, in order
        for (int p = 0; p < P; ++p) {
          tin[p][t] = acc;
          acc = tflag[p] ? tot[p][t] : SR::add(acc, tot[p][t]);
        }
      }
      __syncthreads();
      if (!f)
        sc = add4<SR>(make_float4(tin[sp][4 * sq], tin[sp][4 * sq + 1],
                                  tin[sp][4 * sq + 2], tin[sp][4 * sq + 3]),
                      sc);
      sbuf[quad_slot<G>(sv, sq)] = sc;
      __syncthreads();

      // the row open at each virtual thread's start, where it ended one
      const int vg = v0 + sv;
      if (vend[sv]) {
        const float4 prev = vg == 0 ? splat(SR::identity())
                            : sv > 0 ? sbuf[quad_slot<G>(sv - 1, sq)]
                                     : last[sq];
        const float4 val = add4<SR>(prev, hbuf[quad_slot<G>(sv, sq)]);
        const int fr = vfirst[vg];
        if (fr == 0 && began_before) {   // it began in an earlier window
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * sq + j < kc)
              carry_head[(long long)w * k + c0 + 4 * sq + j] =
                  quad_at(val, j);
        } else {
          ybuf[quad_slot<G>(fr - rb, sq)] = val;
        }
      }
      if (vg == kThreads - 1) {          // row i1, open past the window
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * sq + j < kc)
            carry_tail[(long long)w * k + c0 + 4 * sq + j] =
                quad_at(sc, j);
      }
      __syncthreads();

      // the chunk's rows, column by column in runs of rows, joined with base
      if (t < G) last[t] = sbuf[quad_slot<G>(CV - 1, t)];
      const int nr = vfirst[v0 + CV] - rb;
      for (int e = t; e < nr * G; e += kLanes) {
        const int q = e / nr, r = e - q * nr;
        if (rb + r == 0 && began_before) continue;   // a carry_head
        const float4 val = ybuf[quad_slot<G>(r, q)];
        const long long row = (long long)i0 + rb + r;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (4 * q + j < kc) {
            const long long o = (long long)(c0 + 4 * q + j) * n_rows + row;
            y[o] = base != nullptr ? SR::add(__ldg(base + o), quad_at(val, j))
                                   : quad_at(val, j);
          }
      }
      __syncthreads();
    }
  }
}

// Pass 2, one warp per split row, lane l taking columns l, l + 32, ...: for
// each it replays spmv_csr_seg's split fold -- 32 lane sums, lane j folding
// parts j, j + 32, ... in order, then the xor-butterfly, of which lane 0's
// result is the tree below (at each level lane j < off folds lane j + off
// into its own) -- so one warp reads a row's carries for 32 columns at a
// time, (n_win, k) row-major: coalesced.
template <class SR>
__global__ void __launch_bounds__(kThreads)
spmm_seg_split_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ split_rows, int n_split,
                      const float* __restrict__ carry_head,
                      const float* __restrict__ carry_tail,
                      const float* __restrict__ base, float* __restrict__ y,
                      int window, int n_rows, int k) {
  const int gw = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= n_split) return;
  const int row = split_rows[gw];
  const long long wa = ((long long)row_ptr[row] + row) / window;
  const long long wb = ((long long)row_ptr[row + 1] + row) / window;
  const int parts = (int)(wb - wa) + 1;
  for (int c = lane; c < k; c += 32) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      v[j] = SR::identity();
      for (int q = j; q < parts; q += 32)
        v[j] = SR::add(v[j], q < parts - 1 ? carry_tail[(wa + q) * k + c]
                                           : carry_head[wb * k + c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < off; ++j) v[j] = SR::add(v[j], v[j + off]);
    const long long o = (long long)c * n_rows + row;
    y[o] = base != nullptr ? SR::add(base[o], v[0]) : v[0];
  }
}

struct Args {
  const float* vals;
  const int* cols;
  const int* row_ptr;
  const int* win_row;
  const float* xt;
  const float* base;
  float* y;
  float* head;
  float* tail;
  long long n_items;
  int window, n_rows, n_win, k;
  bool vec;
};

template <class SR, int KC>
int launch_columns(const Args& a, cudaStream_t st) {
  const int bytes = 12 * a.window;
  const cudaError_t e = cudaFuncSetAttribute(
      spmm_seg_window_kernel<SR, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  spmm_seg_window_kernel<SR, KC><<<a.n_win, kThreads, bytes, st>>>(
      a.vals, a.cols, a.row_ptr, a.win_row, a.xt, a.base, a.y, a.head,
      a.tail, a.n_items, a.window, a.n_rows, a.k, a.vec);
  return 0;
}

template <class SR, int G>
int launch_lanes(const Args& a, cudaStream_t st) {
  const int ipt = (a.window + kThreads - 1) / kThreads;
  const int bytes = 16 * kLanes * (ipt + 2) + 12 * a.window;
  const cudaError_t e = cudaFuncSetAttribute(
      spmm_seg_lanes_kernel<SR, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  spmm_seg_lanes_kernel<SR, G><<<a.n_win, kLanes, bytes, st>>>(
      a.vals, a.cols, a.row_ptr, a.win_row, a.xt, a.base, a.y, a.head,
      a.tail, a.n_items, a.window, a.n_rows, a.k, a.vec);
  return 0;
}

// the group width for k columns: ceil(k / 4) lanes, a power of two <= 16
int group_width(int k) {
  int g = 1;
  while (4 * g < k && g < kMaxGroup) g <<= 1;
  return g;
}

template <class SR>
int launch(const Args& a, const int* split_rows, int n_split,
           cudaStream_t st) {
  if (a.n_win > 0) {
    int rc = 0;
    if (a.k <= kMaxTile) {
      switch (column_tile(a.k, kMaxTile)) {
        case 1: rc = launch_columns<SR, 1>(a, st); break;
        case 2: rc = launch_columns<SR, 2>(a, st); break;
        default: rc = launch_columns<SR, 4>(a, st); break;
      }
    } else {
      switch (group_width(a.k)) {
        case 2: rc = launch_lanes<SR, 2>(a, st); break;
        case 4: rc = launch_lanes<SR, 4>(a, st); break;
        case 8: rc = launch_lanes<SR, 8>(a, st); break;
        default: rc = launch_lanes<SR, 16>(a, st); break;
      }
    }
    if (rc != 0) return rc;
  }
  if (n_split > 0)
    spmm_seg_split_kernel<SR>
        <<<(n_split + kWarps - 1) / kWarps, kThreads, 0, st>>>(
            a.row_ptr, split_rows, n_split, a.head, a.tail, a.base, a.y,
            a.window, a.n_rows, a.k);
  return 0;
}

}  // namespace

// xt: (n_cols, k) column-interleaved X; base: (k, n_rows) or null;
// carries: (2, n_win, k) scratch, heads then tails; y: (k, n_rows).
extern "C" int spmm_csr_seg_f32(const void* vals, const void* cols,
                                const void* row_ptr, const void* win_row,
                                const void* split_rows, const void* xt,
                                const void* base, void* carries, void* y,
                                long long nnz, int n_rows, int n_win,
                                int n_split, int window, int k, int semiring,
                                void* stream) {
  if (window < 1 || window > kMaxWindow || k < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.vals = (const float*)vals;
  a.cols = (const int*)cols;
  a.row_ptr = (const int*)row_ptr;
  a.win_row = (const int*)win_row;
  a.xt = (const float*)xt;
  a.base = (const float*)base;
  a.y = (float*)y;
  a.head = (float*)carries;
  a.tail = a.head + (long long)n_win * k;
  a.n_items = nnz + n_rows;
  a.window = window;
  a.n_rows = n_rows;
  a.n_win = n_win;
  a.k = k;
  a.vec = k % 4 == 0 && ((uintptr_t)xt & 15) == 0;
  int rc = 0;
  SEMIRING_DISPATCH(semiring, SR,
    rc = launch<SR>(a, (const int*)split_rows, n_split,
                    (cudaStream_t)stream))
  if (rc != 0) return rc;
  return last_error();
}
