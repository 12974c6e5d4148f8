"""Segmented (merge-path) CSR SpMV under a semiring: the CUDA kernel's
wrapper, its plain version, and the HYB container oracle.

Kernel: `csrc/spmv_csr_seg.cu`, which replaces the TPU kernel
`repro/kernels/spmv_csr_seg.py:spmv_csr_seg_pallas` and the carry-out
merge of `repro/kernels/_layout.py:spmv_csr_seg_prepared`.  Both take a
`_layout.PreparedSegCSR`: the nonzeros in row order (`vals`, `cols`), a
row pointer over every row, and a table of windows that cut the merge
path -- the n_rows row ends and the nnz nonzeros, each row's nonzeros
followed by its end -- into runs of `window` items; `win_row[w]` is the
number of rows that end before window w.  `split_rows` lists the rows
whose items fall into more than one window.

    y[row] = base[row] ⊕ (⊕ over the row's nonzeros of vals ⊗ x[cols])
             (identity for a row with none; `base` optional)

The windows only split the kernel's work; they do not change the
function.

Batched: `spmm_csr_seg` (kernel `csrc/spmm_csr_seg.cu`) computes it for
every row of a (k, n_cols) batch X with a (k, n_rows) base in one
launch, over the same windows and in the same order per column, so
`Y[c]` equals `spmv_csr_seg(seg, X[c], sr, base[c])` bit for bit; the
plain version takes the batch as it is.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import ELL
from repro_torch.graph.semiring import Semiring, cached_on

from . import _build
from .spmv_ell import interleave_columns, spmv_ell_torch

#: merge-path items (row ends and nonzeros) per CTA of the kernel; the
#: kernel stages a window's products, row ends and bases in shared
#: memory (12 bytes an item), so at most MAX_WINDOW
WINDOW, MAX_WINDOW = 2048, 4096


def spmv_csr_seg_plain(seg, x: torch.Tensor, sr: Semiring,
                       base=None) -> torch.Tensor:
    """Plain PyTorch version: products in row order, one ordered ⊕ per
    row (`Semiring.segment`), joined with the base.  `x` (n_cols,) with
    a (n_rows,) base, or a (k, n_cols) batch with a (k, n_rows) base,
    whose rows fold as each alone."""
    owner = cached_on(seg.row_ptr, "row ids", lambda: torch.repeat_interleave(
        torch.arange(seg.n_rows, device=seg.row_ptr.device),
        torch.diff(seg.row_ptr.long())))
    prods = sr.mul(seg.vals, x[..., seg.cols.long()])
    y = sr.segment(prods, owner, seg.n_rows)
    return y if base is None else sr.add(base, y)


def spmv_csr_seg(seg, x: torch.Tensor, sr: Semiring,
                 base=None) -> torch.Tensor:
    """y = base ⊕ (A (⊕,⊗) x) over a prepared stream `seg` (vals f32;
    cols, row_ptr, win_row, split_rows int32).  CUDA tensors launch the
    kernel, CPU tensors run the plain version."""
    tensors = {"vals": torch.float32, "cols": torch.int32,
               "row_ptr": torch.int32, "win_row": torch.int32,
               "split_rows": torch.int32}
    if not _build.on_cuda(x, base,
                          *(getattr(seg, name) for name in tensors)):
        return spmv_csr_seg_plain(seg, x, sr, base)
    for name, dtype in tensors.items():
        _build.require(getattr(seg, name), dtype, name, 1)
    _build.require(x, torch.float32, "x", 1)
    if base is not None:
        _build.require(base, torch.float32, "base", 1)
    nnz, n_rows = seg.vals.shape[0], seg.n_rows
    n_win = seg.win_row.shape[0] - 1
    if not 0 < seg.window <= MAX_WINDOW \
            or seg.cols.shape != seg.vals.shape \
            or seg.row_ptr.shape[0] != n_rows + 1 \
            or n_win != -(-(n_rows + nnz) // seg.window) \
            or x.shape[0] != seg.n_cols \
            or (base is not None and base.shape[0] != n_rows):
        raise ValueError("spmv_csr_seg: inconsistent segment layout")
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return y
    carries = torch.empty((2, n_win), dtype=torch.float32, device=x.device)
    fn = _build.function(
        "spmv_csr_seg", "spmv_csr_seg_f32",
        [_build.PTR] * 9 + [_build.INT64] + [_build.INT] * 5 + [_build.PTR])
    with torch.cuda.device(x.device):
        rc = fn(seg.vals.data_ptr(), seg.cols.data_ptr(),
                seg.row_ptr.data_ptr(), seg.win_row.data_ptr(),
                seg.split_rows.data_ptr(), x.data_ptr(),
                None if base is None else base.data_ptr(), carries.data_ptr(),
                y.data_ptr(), nnz, n_rows, n_win, seg.split_rows.shape[0],
                seg.window, sr.code, _build.stream_of(x))
    _build.check(rc, "spmv_csr_seg", "spmv_csr_seg launch")
    spmv_csr_seg.launches += 1
    return y


spmv_csr_seg.launches = 0


def spmm_csr_seg(seg, X: torch.Tensor, sr: Semiring, base=None,
                 xt=None) -> torch.Tensor:
    """Y = base ⊕ (A (⊕,⊗) X[c]) for every row c of a (k, n_cols) batch,
    as (k, n_rows); `base` (k, n_rows) or None.  CUDA tensors launch the
    batched kernel once, whatever k is, gathering from `xt`
    (`interleave_columns(X)`, made here when not given); CPU tensors run
    the plain version."""
    tensors = {"vals": torch.float32, "cols": torch.int32,
               "row_ptr": torch.int32, "win_row": torch.int32,
               "split_rows": torch.int32}
    if not _build.on_cuda(X, base, xt,
                          *(getattr(seg, name) for name in tensors)):
        return spmv_csr_seg_plain(seg, X, sr, base)
    for name, dtype in tensors.items():
        _build.require(getattr(seg, name), dtype, name, 1)
    _build.require(X, torch.float32, "X", 2)
    k, nnz, n_rows = X.shape[0], seg.vals.shape[0], seg.n_rows
    if base is not None:
        _build.require(base, torch.float32, "base", 2)
    n_win = seg.win_row.shape[0] - 1
    if not 0 < seg.window <= MAX_WINDOW \
            or seg.cols.shape != seg.vals.shape \
            or seg.row_ptr.shape[0] != n_rows + 1 \
            or n_win != -(-(n_rows + nnz) // seg.window) \
            or X.shape[1] != seg.n_cols \
            or (base is not None and base.shape != (k, n_rows)):
        raise ValueError("spmm_csr_seg: inconsistent segment layout")
    Y = torch.empty((k, n_rows), dtype=torch.float32, device=X.device)
    if n_rows == 0 or k == 0:
        return Y
    if xt is None:
        xt = interleave_columns(X)
    _build.require(xt, torch.float32, "xt", 2)
    if xt.shape != (seg.n_cols, k):
        raise ValueError("spmm_csr_seg: xt is not X's interleaved copy")
    carries = torch.empty((2, n_win, k), dtype=torch.float32,
                          device=X.device)
    fn = _build.function(
        "spmm_csr_seg", "spmm_csr_seg_f32",
        [_build.PTR] * 9 + [_build.INT64] + [_build.INT] * 6 + [_build.PTR])
    with torch.cuda.device(X.device):
        rc = fn(seg.vals.data_ptr(), seg.cols.data_ptr(),
                seg.row_ptr.data_ptr(), seg.win_row.data_ptr(),
                seg.split_rows.data_ptr(), xt.data_ptr(),
                None if base is None else base.data_ptr(), carries.data_ptr(),
                Y.data_ptr(), nnz, n_rows, n_win, seg.split_rows.shape[0],
                seg.window, k, sr.code, _build.stream_of(X))
    _build.check(rc, "spmm_csr_seg", "spmm_csr_seg launch")
    spmm_csr_seg.launches += 1
    return Y


spmm_csr_seg.launches = 0


def spmv_hyb_torch(hyb, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """HYB container oracle (the reference's `spmv_hyb_jnp` /
    `spmv_hyb_semiring_jnp`): light ELL ⊕ heavy segment-⊕.  `x` may be a
    (k, n) batch; the light padding must be absorbing."""
    light = ELL(data=hyb.data, indices=hyb.indices, n_rows=hyb.n_rows,
                n_cols=hyb.n_cols, max_nnz=hyb.light_width, fill=hyb.fill)
    y = spmv_ell_torch(light, x, sr)
    if hyb.heavy_nnz == 0:
        return y
    prods = sr.mul(hyb.hvals, x[..., hyb.hcols.long()])
    return sr.add(y, sr.segment(prods, hyb.hrows, hyb.n_rows))
