"""Plan-time layout preparation and the per-call runners.

Counterpart of `repro.kernels._layout`.  Every format gets a `prepare_*`
function that does all matrix-side work once (at plan compile) and a
`spmv_*_prepared` runner that does none: it validates x and calls the
format's kernel wrapper, which launches the CUDA kernel for CUDA
tensors and runs the plain version for CPU tensors.

The padding here is the port's own.  The reference pads to the TPU's
tiles (128-row blocks, widths rounded up to 128 lanes); on the card
that padding would only cost memory -- at 2^20 rows it made every ELL
layout (B, 128, 128) for a 9-wide FD matrix.  The contracts are kept:

  * padding slots hold the semiring's absorbing value, and an ELL or HYB
    container padded with anything else is refused;
  * nnz = 0 and 0-row inputs work (the kernels are not launched on an
    empty grid);
  * the HYB heavy stream stays sorted by column.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import BELL, CSR, DIA, ELL, HYB
from repro_torch.device import (stable_argsort, to_numpy, to_tensor,
                                unique_inverse)
from repro_torch.graph.semiring import Semiring, resolve

from .spmv_bell import BN as BELL_BN, spmv_bell
from .spmv_csr import spmv_csr
from .spmv_csr_seg import LONG_ROW, spmv_csr_seg
from .spmv_dia import spmv_dia
from .spmv_ell import spmv_ell


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _check_x(x: torch.Tensor, n_cols: int) -> None:
    if x.dim() != 1 or x.shape[0] != n_cols:
        raise ValueError(f"x must have shape ({n_cols},), got "
                         f"{tuple(x.shape)}")


def _check_fill(container, sr: Semiring) -> None:
    """Refuse padding that is not absorbing under `sr`: a slot padded
    with 0.0 would read as a real weight-0 edge under min_plus."""
    if container.fill != sr.pad_value:
        raise ValueError(
            f"{type(container).__name__} container is padded with "
            f"{container.fill!r}, which is not absorbing under "
            f"{sr.name!r} (pad_value={sr.pad_value!r}); build it with "
            f"fill=semiring.pad_value")


# ---------------------------------------------------------------------------
# DIA
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreparedDIA:
    """The band as is: one contiguous row per diagonal, no halo."""
    band: torch.Tensor      # (n_diags, n_rows) f32
    offsets: torch.Tensor   # (n_diags,) int32
    n_rows: int
    n_cols: int


def prepare_dia(dia: DIA) -> PreparedDIA:
    return PreparedDIA(band=dia.data.contiguous(),
                       offsets=dia.offsets.contiguous(),
                       n_rows=dia.n_rows, n_cols=dia.n_cols)


def spmv_dia_prepared(prep: PreparedDIA, x: torch.Tensor,
                      semiring=None) -> torch.Tensor:
    if resolve(semiring).name != "plus_times":
        raise ValueError("DIA plans are plus-times only")
    _check_x(x, prep.n_cols)
    return spmv_dia(prep.band, prep.offsets, x, prep.n_cols)


# ---------------------------------------------------------------------------
# BELL
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreparedBELL:
    """The container's blocks minus those that are all zero at block
    column 0 -- the padding blocks, and any real block equal to one,
    which add the same 0 * x[0:bn] -- in container order; `pad0[b]` marks
    the block rows that had one, whose y adds that term (+0, or NaN when
    the first x tile holds a non-finite value)."""
    blocks: torch.Tensor      # (nb, bm, bn) f32
    block_cols: torch.Tensor  # (nb,) int32
    block_ptr: torch.Tensor   # (n_block_rows + 1,) int32
    pad0: torch.Tensor        # (n_block_rows,) uint8
    n_rows: int
    n_cols: int


def prepare_bell(bell: BELL) -> PreparedBELL:
    if bell.bn != BELL_BN:
        raise ValueError(f"prepare_bell: blocks must be {BELL_BN} wide, "
                         f"got bn={bell.bn}")
    dropped = (bell.block_cols == 0) & \
        ~(bell.data != 0).flatten(2).any(dim=2)       # (nbr, bpr)
    keep = ~dropped
    ptr = torch.zeros(bell.data.shape[0] + 1, dtype=torch.int64,
                      device=bell.data.device)
    torch.cumsum(keep.sum(dim=1), 0, out=ptr[1:])
    if int(ptr[-1]) >= np.iinfo(np.int32).max:
        raise ValueError("prepare_bell: too many blocks for int32 offsets")
    return PreparedBELL(blocks=bell.data[keep].contiguous(),
                        block_cols=bell.block_cols[keep].contiguous(),
                        block_ptr=ptr.to(torch.int32),
                        pad0=dropped.any(dim=1).to(torch.uint8),
                        n_rows=bell.n_rows, n_cols=bell.n_cols)


def spmv_bell_prepared(prep: PreparedBELL, x: torch.Tensor,
                       semiring=None) -> torch.Tensor:
    if resolve(semiring).name != "plus_times":
        raise ValueError("BELL plans are plus-times only")
    _check_x(x, prep.n_cols)
    return spmv_bell(prep.blocks, prep.block_cols, prep.block_ptr,
                     prep.pad0, x, prep.n_rows)


# ---------------------------------------------------------------------------
# ELL
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreparedELL:
    """Slot-major ELL: slot w of every row is one contiguous row."""
    data: torch.Tensor      # (W, n_rows) f32, padding = the absorbing value
    idx: torch.Tensor       # (W, n_rows) int32, padding -> col 0
    n_rows: int
    n_cols: int


def prepare_ell(ell: ELL, semiring=None) -> PreparedELL:
    _check_fill(ell, resolve(semiring))
    return PreparedELL(data=ell.data.t().contiguous(),
                       idx=ell.indices.t().contiguous(),
                       n_rows=ell.n_rows, n_cols=ell.n_cols)


def spmv_ell_prepared(prep: PreparedELL, x: torch.Tensor,
                      semiring=None) -> torch.Tensor:
    _check_x(x, prep.n_cols)
    return spmv_ell(prep.data, prep.idx, x, resolve(semiring))


# ---------------------------------------------------------------------------
# Padded CSR (column stripes x row blocks)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PaddedCSR:
    """Cell (s, b) holds the nonzeros of column stripe s and row block b
    in row-major order, padded to the widest cell; `rowptr[s, b, r]` is
    where row r of the block starts inside its cell."""
    vals: torch.Tensor      # (S, B, W) f32, padding = the absorbing value
    cols: torch.Tensor      # (S, B, W) int32 global column, padding 0
    rowptr: torch.Tensor    # (S, B, bm + 1) int32
    n_rows: int
    n_cols: int
    stripe_w: int
    bm: int


def prepare_csr(csr: CSR, n_stripes: int = 1, bm: int = 128,
                semiring=None) -> PaddedCSR:
    """`bm` rows per block (one CUDA thread each, so at most 1024);
    padding slots hold the semiring's absorbing value."""
    if not 0 < bm <= 1024 or n_stripes < 1:
        raise ValueError("prepare_csr needs 0 < bm <= 1024 and "
                         "n_stripes >= 1")
    stripe_w = ceil_div(max(csr.n_cols, 1), n_stripes)
    n_blocks = ceil_div(csr.n_rows, bm)
    n_cells = n_stripes * n_blocks
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths())
    cols = to_numpy(csr.indices).astype(np.int64)
    vals = to_numpy(csr.data)
    cell = (cols // stripe_w) * n_blocks + rows // bm
    order = stable_argsort(cell, csr.device)     # row-major inside a cell
    cell, rows, cols, vals = cell[order], rows[order], cols[order], \
        vals[order]
    counts = np.bincount(cell, minlength=n_cells)
    width = int(counts.max()) if counts.size else 0
    start = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    inner = np.arange(len(cell), dtype=np.int64) - start[cell]
    V = np.full((n_cells, width), resolve(semiring).pad_value,
                dtype=vals.dtype)
    C = np.zeros((n_cells, width), dtype=np.int32)
    V[cell, inner] = vals
    C[cell, inner] = cols.astype(np.int32)
    per_row = np.bincount(cell * bm + rows % bm,
                          minlength=n_cells * bm).reshape(n_cells, bm)
    R = np.zeros((n_cells, bm + 1), dtype=np.int32)
    np.cumsum(per_row, axis=1, out=R[:, 1:])
    dev = csr.device
    shape = (n_stripes, n_blocks)
    return PaddedCSR(vals=to_tensor(V.reshape(*shape, width), dev),
                     cols=to_tensor(C.reshape(*shape, width), dev),
                     rowptr=to_tensor(R.reshape(*shape, bm + 1), dev),
                     n_rows=csr.n_rows, n_cols=csr.n_cols,
                     stripe_w=stripe_w, bm=bm)


def spmv_csr_prepared(prep: PaddedCSR, x: torch.Tensor,
                      semiring=None) -> torch.Tensor:
    _check_x(x, prep.n_cols)
    return spmv_csr(prep.vals, prep.cols, prep.rowptr, x, prep.n_rows,
                    resolve(semiring))


# ---------------------------------------------------------------------------
# Segmented CSR (nnz-balanced flat stream) and HYB
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreparedSegCSR:
    """A flat nonzero stream in segments of `seg_len` slots (the last one
    short, no padding slots); `rid` ranks each slot's row densely within
    its segment, in ascending row order; `order` lists each segment's
    slots (as offsets into the segment) sorted by (rank, slot), so the
    slots of one rank form one run; `merge_ptr`/`merge_idx` list each
    row's (segment, rank) partials -- index s * rwin + r -- in segment
    order; `long_rows` lists the rows with more than `LONG_ROW` partials,
    which the kernel merges with a whole block each."""
    vals: torch.Tensor       # (nnz,) f32
    cols: torch.Tensor       # (nnz,) int32
    rid: torch.Tensor        # (nnz,) int32 rank within the segment
    order: torch.Tensor      # (nnz,) int16 slot offsets, rank-sorted
    merge_ptr: torch.Tensor  # (n_rows + 1,) int32
    merge_idx: torch.Tensor  # (n_partials,) int32
    long_rows: torch.Tensor  # (n_long,) int32, ascending
    n_rows: int
    n_cols: int
    seg_len: int
    rwin: int                # most distinct rows any segment touches


def segment_stream(rows, cols, vals, n_rows: int, n_cols: int,
                   seg_len: int, device) -> PreparedSegCSR:
    """Cut a (rows, cols, vals) stream -- in the order the caller chose:
    row-major for merge-CSR, column-sorted for the HYB heavy part -- into
    segments, ranking rows within each (the sorts run on `device`)."""
    if not 0 < seg_len <= 1024:
        raise ValueError("seg_len must be in 1..1024 (one CUDA block)")
    rows = np.asarray(rows, dtype=np.int64)
    nnz = rows.shape[0]
    n_segs = ceil_div(nnz, seg_len)
    seg = np.arange(nnz, dtype=np.int64) // seg_len
    uniq, inv = unique_inverse(seg * max(n_rows, 1) + rows, device)
    u_seg, u_row = uniq // max(n_rows, 1), uniq % max(n_rows, 1)
    first = np.searchsorted(u_seg, np.arange(n_segs))
    u_rank = np.arange(uniq.size, dtype=np.int64) - first[u_seg]
    rwin = int(u_rank.max()) + 1 if uniq.size else 0
    if n_segs * rwin >= np.iinfo(np.int32).max:
        raise ValueError("segment partials exceed int32 indexing")
    rid = u_rank[inv]
    # sorting by (segment, rank) moves no slot out of its segment, and the
    # stable sort keeps slot order inside each rank's run
    order = stable_argsort(seg * max(rwin, 1) + rid, device) - seg * seg_len
    by_row = stable_argsort(u_row, device)      # keeps segment order
    per_row = np.bincount(u_row, minlength=n_rows)
    merge_ptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(per_row, out=merge_ptr[1:])
    arrays = dict(
        vals=np.asarray(vals), cols=np.asarray(cols).astype(np.int32),
        rid=rid.astype(np.int32), order=order.astype(np.int16),
        merge_ptr=merge_ptr.astype(np.int32),
        merge_idx=(u_seg * rwin + u_rank)[by_row].astype(np.int32),
        long_rows=np.flatnonzero(per_row > LONG_ROW).astype(np.int32))
    return PreparedSegCSR(
        **{k: to_tensor(v, device) for k, v in arrays.items()},
        n_rows=n_rows, n_cols=n_cols, seg_len=seg_len, rwin=rwin)


def prepare_csr_seg(csr: CSR, seg_len: int = 512) -> PreparedSegCSR:
    """The CSR stream, row-major, cut into equal-nnz segments."""
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths())
    return segment_stream(rows, to_numpy(csr.indices), to_numpy(csr.data),
                          csr.n_rows, csr.n_cols, seg_len, csr.device)


def spmv_csr_seg_prepared(prep: PreparedSegCSR, x: torch.Tensor,
                          semiring=None, base=None) -> torch.Tensor:
    _check_x(x, prep.n_cols)
    return spmv_csr_seg(prep, x, resolve(semiring), base=base)


@dataclasses.dataclass(frozen=True)
class PreparedHYB:
    """The ELL kernel over the light rows, then the segmented kernel over
    the column-sorted heavy stream, whose merge pass ⊕-joins the light
    result.  Heavy rows are all padding in the light slab and light rows
    are absent from the heavy stream, so the join is exact."""
    light: PreparedELL
    heavy: PreparedSegCSR
    n_rows: int
    n_cols: int


def prepare_hyb(hyb: HYB, seg_len: int = 512,
                semiring=None) -> PreparedHYB:
    light = prepare_ell(
        ELL(data=hyb.data, indices=hyb.indices, n_rows=hyb.n_rows,
            n_cols=hyb.n_cols, max_nnz=hyb.light_width, fill=hyb.fill),
        semiring)
    heavy = segment_stream(to_numpy(hyb.hrows), to_numpy(hyb.hcols),
                           to_numpy(hyb.hvals), hyb.n_rows, hyb.n_cols,
                           seg_len, hyb.hvals.device)
    return PreparedHYB(light=light, heavy=heavy, n_rows=hyb.n_rows,
                       n_cols=hyb.n_cols)


def spmv_hyb_prepared(prep: PreparedHYB, x: torch.Tensor,
                      semiring=None) -> torch.Tensor:
    y_light = spmv_ell_prepared(prep.light, x, semiring)
    return spmv_csr_seg_prepared(prep.heavy, x, semiring, base=y_light)


__all__ = [
    "ceil_div",
    "PreparedDIA", "prepare_dia", "spmv_dia_prepared",
    "PreparedBELL", "prepare_bell", "spmv_bell_prepared",
    "PreparedELL", "prepare_ell", "spmv_ell_prepared",
    "PaddedCSR", "prepare_csr", "spmv_csr_prepared",
    "PreparedSegCSR", "segment_stream", "prepare_csr_seg",
    "spmv_csr_seg_prepared",
    "PreparedHYB", "prepare_hyb", "spmv_hyb_prepared",
]
