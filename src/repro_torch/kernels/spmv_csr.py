"""Column-striped padded-CSR SpMV under a semiring: the CUDA kernel's
wrapper, its plain version, and the container oracle.

Kernel: `csrc/spmv_csr.cu`, which replaces the TPU kernel
`repro/kernels/spmv_csr.py:spmv_csr_pallas` and the ⊕ over stripes of
`repro/kernels/_layout.py:spmv_csr_prepared`.  Layout (see
`_layout.prepare_csr`): the nonzeros of stripe s and row block b fill
cell (s, b) of `vals`/`cols` (S, B, W) in row-major order, padded with
the absorbing value; `rowptr[s, b, r]` is where row r of the block
starts in its cell.

    partials[s, row] = ⊕ over the row's slots in cell (s, row // bm)
    y[row]           = partials[0, row] ⊕ ... ⊕ partials[S-1, row]
"""
from __future__ import annotations

import torch

from repro_torch.graph.semiring import Semiring, cached_on

from . import _build


def spmv_csr_plain(vals: torch.Tensor, cols: torch.Tensor,
                   rowptr: torch.Tensor, x: torch.Tensor, n_rows: int,
                   sr: Semiring) -> torch.Tensor:
    """Plain PyTorch version on the cell layout: every slot's row is found
    from `rowptr`, then a segment-⊕ per stripe and an ordered ⊕ over the
    stripes."""
    n_stripes, n_blocks, width = vals.shape
    real, target = cached_on(rowptr, ("cell rows", n_rows, width),
                             lambda: _cell_rows(rowptr, n_rows, width))
    prods = sr.mul(vals, x[cols.long()])
    partials = sr.segment(prods[real], target,
                          n_stripes * n_rows).view(n_stripes, n_rows)
    y = partials[0]
    for s in range(1, n_stripes):
        y = sr.add(y, partials[s])
    return y


def _cell_rows(rowptr, n_rows, width):
    """The padded slots of the cell layout (`real`, False past a cell's
    end) and each real slot's row in the stacked (S * n_rows) partials."""
    n_stripes, n_blocks, bm = rowptr.shape[0], rowptr.shape[1], \
        rowptr.shape[2] - 1
    ptr = rowptr.reshape(n_stripes * n_blocks, bm + 1)
    slot = torch.arange(width, dtype=ptr.dtype, device=ptr.device)
    rowin = torch.searchsorted(ptr, slot.expand(ptr.shape[0], width)
                               .contiguous(), right=True) - 1
    rowin = rowin.reshape(n_stripes, n_blocks, width)
    real = rowin < bm                     # slots past a cell's end: padding
    block = torch.arange(n_blocks, device=ptr.device).view(1, -1, 1)
    stripe = torch.arange(n_stripes, device=ptr.device).view(-1, 1, 1)
    target = stripe * n_rows + block * bm + rowin
    return real, target[real]


def spmv_csr(vals: torch.Tensor, cols: torch.Tensor, rowptr: torch.Tensor,
             x: torch.Tensor, n_rows: int, sr: Semiring) -> torch.Tensor:
    """y = A (⊕,⊗) x for the padded-CSR cell layout: vals (S, B, W) f32,
    cols (S, B, W) int32 global columns, rowptr (S, B, bm+1) int32.
    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    if not _build.on_cuda(vals, cols, rowptr, x):
        return spmv_csr_plain(vals, cols, rowptr, x, n_rows, sr)
    _build.require(vals, torch.float32, "vals", 3)
    _build.require(cols, torch.int32, "cols", 3)
    _build.require(rowptr, torch.int32, "rowptr", 3)
    _build.require(x, torch.float32, "x", 1)
    n_stripes, n_blocks, width = vals.shape
    bm = rowptr.shape[2] - 1
    if cols.shape != vals.shape or rowptr.shape[:2] != vals.shape[:2] \
            or not 0 < bm <= 1024 or n_blocks * bm < n_rows:
        raise ValueError("spmv_csr: inconsistent cell layout")
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return y
    partials = torch.empty((n_stripes, n_rows) if n_stripes > 1 else (0,),
                           dtype=torch.float32, device=x.device)
    fn = _build.function("spmv_csr", "spmv_csr_f32",
                         [_build.PTR] * 6 + [_build.INT] * 6 + [_build.PTR])
    with torch.cuda.device(x.device):
        rc = fn(vals.data_ptr(), cols.data_ptr(), rowptr.data_ptr(),
                x.data_ptr(), partials.data_ptr(), y.data_ptr(), n_rows,
                n_stripes, n_blocks, width, bm, sr.code, _build.stream_of(x))
    _build.check(rc, "spmv_csr", "spmv_csr launch")
    spmv_csr.launches += 1
    return y


spmv_csr.launches = 0


def spmv_csr_torch(csr, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Container oracle (the reference's `spmv_csr_jnp` /
    `spmv_csr_semiring_jnp`): gather, ⊗, segment-⊕ by row; empty rows
    read the ⊕-identity.  `x` may be a (k, n) batch."""
    row_ids = cached_on(csr.indptr, "row ids", lambda: torch.repeat_interleave(
        torch.arange(csr.n_rows, device=csr.data.device),
        torch.diff(csr.indptr.long())))
    prods = sr.mul(csr.data, x[..., csr.indices.long()])
    return sr.segment(prods, row_ids, csr.n_rows)
