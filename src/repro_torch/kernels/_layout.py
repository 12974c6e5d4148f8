"""Plan-time layout preparation and the per-call runners.

Counterpart of `repro.kernels._layout`.  Every format gets a `prepare_*`
function that does all matrix-side work once (at plan compile) and a
`spmv_*_prepared` runner that does none: it validates x and calls the
format's kernel wrapper, which launches the CUDA kernel for CUDA
tensors and runs the plain version for CPU tensors.  ELL, segmented
CSR and HYB also have a batched runner, `spmm_*_prepared`, for a
(k, n_cols) batch: one launch of each batched kernel whatever k is,
each row as its `spmv_*_prepared` gives it, bit for bit.

The padding here is the port's own.  The reference pads to the TPU's
tiles (128-row blocks, widths rounded up to 128 lanes); on the card
that padding would only cost memory -- at 2^20 rows it made every ELL
layout (B, 128, 128) for a 9-wide FD matrix.  The contracts are kept:

  * padding slots hold the semiring's absorbing value, and an ELL or HYB
    container padded with anything else is refused;
  * nnz = 0 and 0-row inputs work (the kernels are not launched on an
    empty grid).

The HYB heavy stream, which the reference keeps sorted by column for the
TPU, is put in row order here: the card's kernel folds each row's run
and writes two carries per window instead of one partial per nonzero.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import BELL, CSR, DIA, ELL, HYB
from repro_torch.device import stable_argsort, to_numpy, to_tensor
from repro_torch.graph.semiring import Semiring, resolve

from .spmv_bell import BN as BELL_BN, spmv_bell
from .spmv_csr import spmv_csr
from .spmv_csr_seg import MAX_WINDOW, WINDOW, spmm_csr_seg, spmv_csr_seg
from .spmv_dia import spmv_dia
from .spmv_ell import interleave_columns, spmm_ell, spmv_ell


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _check_x(x: torch.Tensor, n_cols: int) -> None:
    if x.dim() != 1 or x.shape[0] != n_cols:
        raise ValueError(f"x must have shape ({n_cols},), got "
                         f"{tuple(x.shape)}")


def _check_X(X: torch.Tensor, n_cols: int) -> None:
    if X.dim() != 2 or X.shape[1] != n_cols:
        raise ValueError(f"X must have shape (k, {n_cols}), got "
                         f"{tuple(X.shape)}")


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
    which add the same 0 * x[0:bn] -- in container order, each
    compressed to its kept columns: the columns where some row of the
    block is nonzero (bit n % 32 of `masks[p, n // 32]`), whose values
    are stored dense, column by column (bm per column, explicit zeros
    included), from `values[val_ptr[p]]`.  `pad0[b]` marks the block
    rows that had a dropped block, whose y adds 0 * x[0:bn] (+0, or NaN
    when the first x tile holds a non-finite value); a dropped column
    adds the same term of its own tile."""
    values: torch.Tensor      # (Σ bm * k_p,) f32
    val_ptr: torch.Tensor     # (nb,) int64
    masks: torch.Tensor       # (nb, 4) int32, 128 bits per block
    block_cols: torch.Tensor  # (nb,) int32
    block_ptr: torch.Tensor   # (n_block_rows + 1,) int32
    pad0: torch.Tensor        # (n_block_rows,) uint8
    n_rows: int
    n_cols: int
    bm: int
    lanes: int                # lanes per row in the kernel's fold


def _bell_lanes(bm: int, mean_kept: float) -> int:
    """Lanes per row for blocks of `mean_kept` kept columns on average:
    one per 16 columns (rounded up to a power of two), at most 32 // bm.
    Narrow blocks get one lane a row, so a warp walks several block rows
    at once."""
    want = max(1, -(-int(np.ceil(mean_kept)) // 16))
    return min(32 // bm, 1 << (want - 1).bit_length())


def prepare_bell(bell: BELL) -> PreparedBELL:
    if bell.bn != BELL_BN:
        raise ValueError(f"prepare_bell: blocks must be {BELL_BN} wide, "
                         f"got bn={bell.bn}")
    if not 0 < bell.bm <= 32 or 32 % bell.bm:
        raise ValueError(f"prepare_bell: bm must divide 32 (a warp's "
                         f"lanes split over the rows), got bm={bell.bm}")
    nonzero = bell.data != 0                          # (nbr, bpr, bm, bn)
    dropped = (bell.block_cols == 0) & ~nonzero.flatten(2).any(dim=2)
    keep = ~dropped
    ptr = torch.zeros(bell.data.shape[0] + 1, dtype=torch.int64,
                      device=bell.data.device)
    torch.cumsum(keep.sum(dim=1), 0, out=ptr[1:])
    if int(ptr[-1]) >= np.iinfo(np.int32).max:
        raise ValueError("prepare_bell: too many blocks for int32 offsets")
    kept = nonzero[keep].any(dim=1)                   # (nb, bn)
    # column-major inside a block: the kept columns' bm values each
    values = bell.data[keep].transpose(1, 2)[kept].reshape(-1)
    per_block = bell.bm * kept.sum(dim=1)
    val_ptr = torch.cumsum(per_block, 0) - per_block
    mean_kept = float(kept.sum()) / max(kept.shape[0], 1)
    words = (kept.reshape(-1, 4, 32).long() << torch.arange(
        32, device=kept.device)).sum(dim=2)
    masks = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return PreparedBELL(values=values.contiguous(), val_ptr=val_ptr,
                        masks=masks.to(torch.int32).contiguous(),
                        block_cols=bell.block_cols[keep].contiguous(),
                        block_ptr=ptr.to(torch.int32),
                        pad0=dropped.any(dim=1).to(torch.uint8),
                        n_rows=bell.n_rows, n_cols=bell.n_cols, bm=bell.bm,
                        lanes=_bell_lanes(bell.bm, mean_kept))


def spmv_bell_prepared(prep: PreparedBELL, x: torch.Tensor,
                       semiring=None) -> torch.Tensor:
    if resolve(semiring).name != "plus_times":
        raise ValueError("BELL plans are plus-times only")
    _check_x(x, prep.n_cols)
    return spmv_bell(prep, x)


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


def spmm_ell_prepared(prep: PreparedELL, X: torch.Tensor, semiring=None,
                      xt=None) -> torch.Tensor:
    """Y[c] = `spmv_ell_prepared(prep, X[c])` for a (k, n_cols) batch."""
    _check_X(X, prep.n_cols)
    return spmm_ell(prep.data, prep.idx, X, resolve(semiring), xt=xt)


# ---------------------------------------------------------------------------
# ELL row shards (the row-sharded plans of `repro_torch.distributed`)
# ---------------------------------------------------------------------------

def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


@dataclasses.dataclass(frozen=True)
class ShardedELL:
    """Row-partitioned ELL, the reference's layout byte for byte: one
    (rows_pad, W) slab per part, stacked, on the host.  Columns stay
    global (x is replicated); padding slots index column 0 with value 0,
    and their 0 * x[0] products stay in each row's sum, as in the
    reference.  `slabs(devices)` gives each part's slot-major (W,
    rows_pad) transpose on its device -- the layout the ELL kernel
    reads -- made once per device list and kept."""
    data: np.ndarray          # (parts, rows_pad, W) f32
    idx: np.ndarray           # (parts, rows_pad, W) int32, global columns
    n_rows: int
    n_cols: int
    starts: np.ndarray        # (parts + 1,) int64 row range per part
    bm: int                   # the reference's row block (rows_pad % bm == 0)
    _bound: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def n_parts(self) -> int:
        return int(self.data.shape[0])

    def nbytes(self) -> int:
        return int(self.data.nbytes + self.idx.nbytes)

    def slabs(self, devices) -> tuple:
        """((data_t, idx_t) per part, on `devices[part]`)."""
        key = tuple(torch.device(d) for d in devices)
        if len(key) != self.n_parts:
            raise ValueError(f"partition has {self.n_parts} parts for "
                             f"{len(key)} devices on axis 'shards'")
        if key not in self._bound:
            self._bound[key] = tuple(
                (to_tensor(self.data[p], dev).t().contiguous(),
                 to_tensor(self.idx[p], dev).t().contiguous())
                for p, dev in enumerate(key))
        return self._bound[key]


def prepare_ell_shards(csr: CSR, partition, bm: int = 128,
                       pad_mult: int = 128) -> ShardedELL:
    """Pack each `RowPartition` part into one padded ELL slab.  Every
    slab has the global max row length rounded up to `pad_mult` slots
    and the largest part's rows rounded up to `bm`, as in the
    reference."""
    starts = np.asarray(partition.starts, dtype=np.int64)
    n_parts = len(starts) - 1
    indptr = to_numpy(csr.indptr).astype(np.int64)
    row_len = np.diff(indptr)
    w = round_up(max(int(row_len.max()) if len(row_len) else 1, 1), pad_mult)
    rows_pad = round_up(max(int(np.diff(starts).max()), 1), bm)

    vals = to_numpy(csr.data)
    D = np.zeros((n_parts, rows_pad, w), dtype=vals.dtype)
    C = np.zeros((n_parts, rows_pad, w), dtype=np.int32)
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), row_len)
    part_of = np.searchsorted(starts, rows, side="right") - 1
    inner = np.arange(csr.nnz, dtype=np.int64) - indptr[rows]
    D[part_of, rows - starts[part_of], inner] = vals
    C[part_of, rows - starts[part_of], inner] = \
        to_numpy(csr.indices).astype(np.int32)
    return ShardedELL(data=D, idx=C, n_rows=csr.n_rows, n_cols=csr.n_cols,
                      starts=starts, bm=bm)


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
# Segmented CSR (merge-path windows over a row-major stream) and HYB
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PreparedSegCSR:
    """A row-major nonzero stream with a row pointer over every row, cut
    into merge-path windows: the merge path is the sequence of row ends
    and nonzeros (row r's nonzeros, then its end, at positions
    row_ptr[r] + r .. row_ptr[r+1] + r), window w holds its items
    [w * window, (w + 1) * window), and `win_row[w]` counts the rows that
    end before it (`win_row[-1] == n_rows`).  `split_rows` lists, in
    ascending order, the rows whose items fall into more than one
    window; the kernel folds their parts in a second pass."""
    vals: torch.Tensor        # (nnz,) f32, row-major
    cols: torch.Tensor        # (nnz,) int32
    row_ptr: torch.Tensor     # (n_rows + 1,) int32
    win_row: torch.Tensor     # (n_win + 1,) int32
    split_rows: torch.Tensor  # (n_split,) int32, ascending
    n_rows: int
    n_cols: int
    window: int


def segment_stream(row_ptr, cols, vals, n_rows: int, n_cols: int,
                   window: int, device) -> PreparedSegCSR:
    """Cut a row-major stream, given by its row pointer over every row,
    into merge-path windows of `window` items."""
    if not 0 < window <= MAX_WINDOW:
        raise ValueError(f"the window must be in 1..{MAX_WINDOW} items "
                         "(the kernel stages one in shared memory)")
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    nnz = int(row_ptr[-1])
    if nnz >= np.iinfo(np.int32).max:
        raise ValueError("segment_stream: more nonzeros than int32 "
                         "row pointers can index")
    n_items = n_rows + nnz
    n_win = ceil_div(n_items, window)
    ends = row_ptr[1:] + np.arange(n_rows)        # a row end's position
    starts = row_ptr[:-1] + np.arange(n_rows)     # its first item
    diag = np.minimum(np.arange(n_win + 1, dtype=np.int64) * window,
                      n_items)
    arrays = dict(
        vals=np.asarray(vals), cols=np.asarray(cols).astype(np.int32),
        row_ptr=row_ptr.astype(np.int32),
        win_row=np.searchsorted(ends, diag).astype(np.int32),
        split_rows=np.flatnonzero(starts // window != ends // window)
        .astype(np.int32))
    return PreparedSegCSR(
        **{k: to_tensor(v, device) for k, v in arrays.items()},
        n_rows=n_rows, n_cols=n_cols, window=window)


def prepare_csr_seg(csr: CSR, seg_len: int = WINDOW) -> PreparedSegCSR:
    """The CSR stream as it is (row-major), in windows of `seg_len`
    merge-path items."""
    return segment_stream(to_numpy(csr.indptr), to_numpy(csr.indices),
                          to_numpy(csr.data), csr.n_rows, csr.n_cols,
                          seg_len, csr.device)


def spmv_csr_seg_prepared(prep: PreparedSegCSR, x: torch.Tensor,
                          semiring=None, base=None) -> torch.Tensor:
    _check_x(x, prep.n_cols)
    return spmv_csr_seg(prep, x, resolve(semiring), base=base)


def spmm_csr_seg_prepared(prep: PreparedSegCSR, X: torch.Tensor,
                          semiring=None, base=None, xt=None) -> torch.Tensor:
    """Y[c] = `spmv_csr_seg_prepared(prep, X[c], base=base[c])` for a
    (k, n_cols) batch and a (k, n_rows) base."""
    _check_X(X, prep.n_cols)
    return spmm_csr_seg(prep, X, resolve(semiring), base=base, xt=xt)


@dataclasses.dataclass(frozen=True)
class PreparedHYB:
    """The ELL kernel over the light rows, then the segmented kernel over
    the heavy stream in row order, which ⊕-joins the light result into
    every row.  Heavy rows are all padding in the light slab and light rows
    are absent from the heavy stream, so the join is exact."""
    light: PreparedELL
    heavy: PreparedSegCSR
    n_rows: int
    n_cols: int


def prepare_hyb(hyb: HYB, seg_len: int = WINDOW,
                semiring=None) -> PreparedHYB:
    """The light slab for the ELL kernel; the column-sorted heavy stream
    put in row order by a stable sort (each row keeps the container's
    column order), with a row pointer over every row."""
    light = prepare_ell(
        ELL(data=hyb.data, indices=hyb.indices, n_rows=hyb.n_rows,
            n_cols=hyb.n_cols, max_nnz=hyb.light_width, fill=hyb.fill),
        semiring)
    rows = to_numpy(hyb.hrows)
    order = stable_argsort(rows, hyb.hvals.device)
    row_ptr = np.zeros(hyb.n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=hyb.n_rows), out=row_ptr[1:])
    heavy = segment_stream(row_ptr, to_numpy(hyb.hcols)[order],
                           to_numpy(hyb.hvals)[order], hyb.n_rows,
                           hyb.n_cols, seg_len, hyb.hvals.device)
    return PreparedHYB(light=light, heavy=heavy, n_rows=hyb.n_rows,
                       n_cols=hyb.n_cols)


def spmv_hyb_prepared(prep: PreparedHYB, x: torch.Tensor,
                      semiring=None) -> torch.Tensor:
    y_light = spmv_ell_prepared(prep.light, x, semiring)
    return spmv_csr_seg_prepared(prep.heavy, x, semiring, base=y_light)


def spmm_hyb_prepared(prep: PreparedHYB, X: torch.Tensor,
                      semiring=None) -> torch.Tensor:
    """Y[c] = `spmv_hyb_prepared(prep, X[c])` for a (k, n_cols) batch: the
    batched ELL kernel over the light rows, then the batched segmented
    kernel with that (k, n_rows) result as its base.  The heavy stream
    gathers from one interleaved copy of X, which a random light slab
    shares."""
    _check_X(X, prep.n_cols)
    xt = interleave_columns(X)
    Y_light = spmm_ell_prepared(prep.light, X, semiring, xt=xt)
    return spmm_csr_seg_prepared(prep.heavy, X, semiring, base=Y_light,
                                 xt=xt)


__all__ = [
    "ceil_div",
    "PreparedDIA", "prepare_dia", "spmv_dia_prepared",
    "PreparedBELL", "prepare_bell", "spmv_bell_prepared",
    "PreparedELL", "prepare_ell", "spmv_ell_prepared", "spmm_ell_prepared",
    "round_up", "ShardedELL", "prepare_ell_shards",
    "PaddedCSR", "prepare_csr", "spmv_csr_prepared",
    "PreparedSegCSR", "segment_stream", "prepare_csr_seg",
    "spmv_csr_seg_prepared", "spmm_csr_seg_prepared",
    "PreparedHYB", "prepare_hyb", "spmv_hyb_prepared", "spmm_hyb_prepared",
]
