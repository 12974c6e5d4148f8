"""Segmented (merge) CSR SpMV under a semiring: the CUDA kernel's
wrapper, its plain version, and the HYB container oracle.

Kernel: `csrc/spmv_csr_seg.cu`, which replaces the TPU kernel
`repro/kernels/spmv_csr_seg.py:spmv_csr_seg_pallas` and the carry-out
merge of `repro/kernels/_layout.py:spmv_csr_seg_prepared`.  Both take a
`_layout.PreparedSegCSR`: a flat nonzero stream cut into segments of
`seg_len` slots; `rid` is each slot's dense row rank within its segment;
`order` lists each segment's slots sorted by (rank, slot); `merge_ptr`
/ `merge_idx` list, per row and in segment order, the (segment, rank)
partials that belong to it; `long_rows` names the rows with more than
`LONG_ROW` partials.

    partials[s, r] = ⊕ over the slots of segment s with rank r, in slot
                     order
    y[row]         = base[row] ⊕ (⊕ over the row's partials)   (identity
                     for a row with none; `base` optional)

`order` and `long_rows` only split the kernel's work; they do not change
the function.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import ELL
from repro_torch.graph.semiring import Semiring

from . import _build
from .spmv_ell import spmv_ell_torch

#: a row with more partials than this is merged by a whole block (a
#: power-law hub can own tens of thousands; one thread would serialise)
LONG_ROW = 32


def spmv_csr_seg_plain(seg, x: torch.Tensor, sr: Semiring,
                       base=None) -> torch.Tensor:
    """Plain PyTorch version: the products taken in `order` (rank runs),
    segment-⊕ by (segment, rank), then by row."""
    nnz, L = seg.vals.shape[0], seg.seg_len
    n_segs = -(-nnz // L)
    segment = torch.arange(nnz, device=x.device) // L
    slot = segment * L + seg.order.long()
    prods = sr.mul(seg.vals[slot], x[seg.cols[slot].long()])
    partials = sr.segment(prods, segment * seg.rwin + seg.rid[slot].long(),
                          n_segs * seg.rwin)
    owner = torch.repeat_interleave(
        torch.arange(seg.n_rows, device=x.device),
        torch.diff(seg.merge_ptr.long()))
    y = sr.segment(partials[seg.merge_idx.long()], owner, seg.n_rows)
    return y if base is None else sr.add(base, y)


def spmv_csr_seg(seg, x: torch.Tensor, sr: Semiring,
                 base=None) -> torch.Tensor:
    """y = base ⊕ (A (⊕,⊗) x) over a segmented stream `seg` (vals f32;
    cols, rid, merge_ptr, merge_idx, long_rows int32; order int16).
    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    tensors = {"vals": torch.float32, "cols": torch.int32,
               "rid": torch.int32, "order": torch.int16,
               "merge_ptr": torch.int32, "merge_idx": torch.int32,
               "long_rows": torch.int32}
    if not _build.on_cuda(x, base,
                          *(getattr(seg, name) for name in tensors)):
        return spmv_csr_seg_plain(seg, x, sr, base)
    for name, dtype in tensors.items():
        _build.require(getattr(seg, name), dtype, name, 1)
    _build.require(x, torch.float32, "x", 1)
    if base is not None:
        _build.require(base, torch.float32, "base", 1)
    nnz, n_rows = seg.vals.shape[0], seg.n_rows
    n_segs = -(-nnz // seg.seg_len)
    if not (0 < seg.seg_len <= 1024 and 0 <= seg.rwin <= seg.seg_len) \
            or not seg.cols.shape == seg.rid.shape == seg.order.shape \
            == seg.vals.shape \
            or seg.merge_ptr.shape[0] != n_rows + 1 \
            or x.shape[0] != seg.n_cols \
            or (base is not None and base.shape[0] != n_rows):
        raise ValueError("spmv_csr_seg: inconsistent segment layout")
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return y
    partials = torch.empty(n_segs * seg.rwin, dtype=torch.float32,
                           device=x.device)
    fn = _build.function(
        "spmv_csr_seg", "spmv_csr_seg_f32",
        [_build.PTR] * 11 + [_build.INT64] + [_build.INT] * 7 + [_build.PTR])
    with torch.cuda.device(x.device):
        rc = fn(seg.vals.data_ptr(), seg.cols.data_ptr(),
                seg.rid.data_ptr(), seg.order.data_ptr(),
                seg.merge_ptr.data_ptr(), seg.merge_idx.data_ptr(),
                seg.long_rows.data_ptr(), x.data_ptr(),
                None if base is None else base.data_ptr(),
                partials.data_ptr(), y.data_ptr(), nnz, n_rows, n_segs,
                seg.seg_len, seg.rwin, seg.long_rows.shape[0], LONG_ROW,
                sr.code, _build.stream_of(x))
    _build.check(rc, "spmv_csr_seg", "spmv_csr_seg launch")
    spmv_csr_seg.launches += 1
    return y


spmv_csr_seg.launches = 0


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
