"""Sparse-matrix containers of the port: CSR, ELL, BELL, DIA and HYB.

Counterpart of `repro.core.formats`.  Each container is a frozen
dataclass whose array fields are torch tensors, declared in the
reference's order and built host-side in numpy with the reference's
dtypes (int32 indices; an int32 `indptr` unless nnz >= 2^31), so the
bytes -- and hence the plan fingerprints -- match the reference's for
the same matrix.

Conversions (`from_csr`) put their result on the source matrix's device
unless told otherwise.  ELL and HYB also record the `fill` their short
rows were padded with: the semiring kernels refuse a container whose
padding is not the semiring's absorbing element.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import (resolve_device, stable_argsort, to_numpy,
                                to_tensor, unique_inverse)


def array_fields(container) -> Tuple[torch.Tensor, ...]:
    """The container's tensors in declaration order (what a fingerprint
    hashes, matching the reference's pytree leaves)."""
    return tuple(getattr(container, f.name)
                 for f in dataclasses.fields(container)
                 if isinstance(getattr(container, f.name), torch.Tensor))


def _moved(container, device):
    """`container` with every tensor on `device` (no copy when already
    there)."""
    dev = torch.device(device)
    return dataclasses.replace(container, **{
        f.name: getattr(container, f.name).to(dev)
        for f in dataclasses.fields(container)
        if isinstance(getattr(container, f.name), torch.Tensor)})


def coo_order(rows: np.ndarray, cols: np.ndarray, n_cols: int,
              device=None) -> np.ndarray:
    """Stable (row, col) order of a coordinate stream: the permutation
    `np.lexsort((cols, rows))` gives, as one sort of a combined key (on
    `device`)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    _check_cols(cols, n_cols)
    return stable_argsort(rows * max(n_cols, 1) + cols, device)


def _check_cols(cols: np.ndarray, n_cols: int) -> None:
    if cols.size and (cols.min() < 0 or cols.max() >= max(n_cols, 1)):
        raise ValueError(f"column indices out of range for n_cols={n_cols}")


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row: 2m + n + 1 stored elements."""

    data: torch.Tensor      # (nnz,) values
    indices: torch.Tensor   # (nnz,) int32 column per nonzero
    indptr: torch.Tensor    # (n_rows + 1,) offsets into data
    n_rows: int
    n_cols: int

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def storage_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in array_fields(self))

    def to(self, device) -> "CSR":
        return _moved(self, device)

    def row_lengths(self) -> np.ndarray:
        return np.diff(to_numpy(self.indptr))

    def to_dense(self) -> torch.Tensor:
        """The dense (n_rows, n_cols) matrix on the CSR's device;
        duplicate coordinates are summed in stream order (`np.add.at`),
        as the reference sums them."""
        vals = to_numpy(self.data)
        out = np.zeros(self.shape, dtype=vals.dtype)
        np.add.at(out, (_csr_rows(self), to_numpy(self.indices)), vals)
        return to_tensor(out, self.device)

    def apply_delta(self, delta) -> "CSR":
        """This matrix with a `repro_torch.core.delta.EdgeDelta` applied,
        on the same device: deleted coordinates removed structurally,
        inserts appended, rebuilt canonically through `from_coo`.  The
        streaming plan lifecycle calls it when a delta outgrows its
        overlay budget and the plan re-compiles."""
        from .delta import apply_delta as _apply
        return _apply(self, delta)

    def permute(self, row_perm=None, col_perm=None) -> "CSR":
        """A' with A'[i, j] = A[row_perm[i], col_perm[j]] (`row_perm[i]`
        names the OLD row at NEW position i; None is the identity).
        Rebuilt through `from_coo`, so the result is canonically sorted
        and duplicate coordinates survive, as in the reference; raises
        ValueError on a non-permutation."""
        def invert(perm, n, name):
            perm = np.asarray(perm, dtype=np.int64)
            if perm.shape != (n,) or \
                    not np.array_equal(np.bincount(perm, minlength=n),
                                       np.ones(n, dtype=np.int64)):
                raise ValueError(f"{name} is not a permutation of range({n})")
            inv = np.empty(n, dtype=np.int64)
            inv[perm] = np.arange(n, dtype=np.int64)
            return inv

        cols = to_numpy(self.indices).astype(np.int64)
        vals = to_numpy(self.data)
        rows = _csr_rows(self)
        if row_perm is not None:
            rows = invert(row_perm, self.n_rows, "row_perm")[rows]
        if col_perm is not None:
            cols = invert(col_perm, self.n_cols, "col_perm")[cols]
        return CSR.from_coo(rows, cols, vals, self.n_rows, self.n_cols,
                            dtype=vals.dtype, device=self.device)

    @staticmethod
    def from_coo(rows, cols, vals, n_rows, n_cols, dtype=np.float32,
                 device=None) -> "CSR":
        """Canonical (row, col)-sorted CSR; duplicates are kept, in
        stream order, exactly as the reference keeps them.  The sort,
        the gathers and the row counts run on `device`."""
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=dtype)
        if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
            raise ValueError(f"row indices out of range for n_rows={n_rows}")
        _check_cols(cols, n_cols)
        dev = resolve_device(device)
        return csr_from_coo_tensors(
            *(to_tensor(a, dev) for a in (rows, cols, vals)), n_rows, n_cols)


def csr_from_coo_tensors(r: torch.Tensor, c: torch.Tensor, v: torch.Tensor,
                         n_rows: int, n_cols: int) -> CSR:
    """`CSR.from_coo` of int64 coordinates (in range) and values already
    on one device, as torch ops there: one stable sort (its permutation
    is unique, so it is `np.lexsort`'s), exact gathers and integer row
    counts; an int32 `indptr` unless nnz >= 2^31."""
    order = torch.sort(r * max(n_cols, 1) + c, stable=True).indices
    counts = torch.bincount(r, minlength=n_rows)[:n_rows]
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    if int(indptr[-1]) < np.iinfo(np.int32).max:
        indptr = indptr.int()
    return CSR(data=v[order], indices=c[order].int(), indptr=indptr,
               n_rows=int(n_rows), n_cols=int(n_cols))


def csr_from_numpy(data, indices, indptr, n_rows: int, n_cols: int,
                   device=None) -> CSR:
    """The port's CSR over another implementation's arrays (anything
    numpy can read), dtypes and bytes unchanged -- how the same matrix
    is fed to the reference and the port."""
    dev = resolve_device(device)
    return CSR(data=to_tensor(np.asarray(data), dev),
               indices=to_tensor(np.asarray(indices), dev),
               indptr=to_tensor(np.asarray(indptr), dev),
               n_rows=int(n_rows), n_cols=int(n_cols))


def _csr_rows(csr: CSR) -> np.ndarray:
    """Row id of every stored nonzero (int64, CSR order)."""
    return np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths())


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK: every row padded to `max_nnz` slots (pad col 0, value
    `fill`)."""

    data: torch.Tensor      # (n_rows, max_nnz)
    indices: torch.Tensor   # (n_rows, max_nnz) int32; padding -> col 0
    n_rows: int
    n_cols: int
    max_nnz: int
    fill: float = 0.0

    @staticmethod
    def from_csr(csr: CSR, max_nnz: int | None = None, fill: float = 0.0,
                 device=None) -> "ELL":
        """`fill` pads short rows: 0.0 for plus-times, the semiring's
        absorbing element otherwise.  Rows longer than `max_nnz` are cut
        to their first `max_nnz` entries, as in the reference."""
        lengths = csr.row_lengths()
        width = (int(lengths.max()) if len(lengths) else 0) \
            if max_nnz is None else int(max_nnz)
        vals = to_numpy(csr.data)
        data = np.full((csr.n_rows, width), fill, dtype=vals.dtype)
        idx = np.zeros((csr.n_rows, width), dtype=np.int32)
        if csr.nnz and width:
            rows = _csr_rows(csr)
            indptr = to_numpy(csr.indptr).astype(np.int64)
            inner = np.arange(csr.nnz, dtype=np.int64) - indptr[rows]
            keep = inner < width
            data[rows[keep], inner[keep]] = vals[keep]
            idx[rows[keep], inner[keep]] = to_numpy(csr.indices)[keep]
        dev = csr.device if device is None else torch.device(device)
        return ELL(data=to_tensor(data, dev), indices=to_tensor(idx, dev),
                   n_rows=csr.n_rows, n_cols=csr.n_cols, max_nnz=width,
                   fill=float(fill))


@dataclasses.dataclass(frozen=True)
class BELL:
    """Blocked ELL: dense (bm, bn) blocks, `blocks_per_row` per block row
    of bm rows; padding blocks have block column 0 and all-zero data."""

    data: torch.Tensor        # (n_block_rows, blocks_per_row, bm, bn)
    block_cols: torch.Tensor  # (n_block_rows, blocks_per_row) int32
    n_rows: int
    n_cols: int
    bm: int
    bn: int
    blocks_per_row: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def n_block_rows(self) -> int:
        return -(-self.n_rows // self.bm)

    def storage_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in array_fields(self))

    def density(self) -> float:
        """Fraction of stored block entries that are true nonzeros."""
        return float(torch.count_nonzero(self.data)) / self.data.numel()

    @staticmethod
    def from_csr(csr: CSR, bm: int = 8, bn: int = 128,
                 blocks_per_row: int | None = None, device=None) -> "BELL":
        """The reference's blocks, vectorised: blocks sorted by block
        column within a block row, `blocks_per_row` (default: the widest
        block row, at least 1) keeping the lowest block columns, padding
        blocks at block column 0 with zero data.  Duplicate coordinates
        are summed in CSR order (`np.add.at`), as the reference's
        per-nonzero loop sums them.  Only the real blocks are built on
        the host; the padded container is filled on `device`."""
        nbr = -(-csr.n_rows // bm)
        nbc = max(-(-csr.n_cols // bn), 1)
        dev = csr.device if device is None else torch.device(device)
        rows = _csr_rows(csr)
        cols = to_numpy(csr.indices).astype(np.int64)
        vals = to_numpy(csr.data)
        keys, blk = unique_inverse((rows // bm) * nbc + cols // bn,
                                   csr.device)
        brow, bcol = keys // nbc, keys % nbc
        counts = np.bincount(brow, minlength=nbr)
        width = blocks_per_row or int(counts.max(initial=1))
        width = max(width, 1)
        first = np.zeros(nbr + 1, dtype=np.int64)
        np.cumsum(counts, out=first[1:])
        slot = np.arange(keys.size, dtype=np.int64) - first[brow]
        keep = slot < width
        blocks = np.zeros((keys.size, bm, bn), dtype=vals.dtype)
        np.add.at(blocks.reshape(-1),
                  (blk * bm + rows % bm) * bn + cols % bn, vals)
        real = to_tensor(blocks[keep], dev)
        data = torch.zeros((nbr, width, bm, bn), dtype=real.dtype,
                           device=dev)
        bcols = torch.zeros((nbr, width), dtype=torch.int32, device=dev)
        at = (to_tensor(brow[keep], dev), to_tensor(slot[keep], dev))
        data[at] = real
        bcols[at] = to_tensor(bcol[keep].astype(np.int32), dev)
        return BELL(data=data, block_cols=bcols, n_rows=csr.n_rows,
                    n_cols=csr.n_cols, bm=bm, bn=bn, blocks_per_row=width)


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal storage: `data[k, i]` is A[i, i + offsets[k]]; entries
    outside the matrix are zero."""

    data: torch.Tensor      # (n_diags, n_rows)
    offsets: torch.Tensor   # (n_diags,) int32 column offset per diagonal
    n_rows: int
    n_cols: int

    @staticmethod
    def from_csr(csr: CSR, device=None) -> "DIA":
        """Vectorised: `np.add.at` accumulates in stream order, so
        duplicate coordinates sum exactly as the reference's per-nonzero
        loop sums them."""
        rows = _csr_rows(csr)
        vals = to_numpy(csr.data)
        offs = to_numpy(csr.indices).astype(np.int64) - rows
        uniq, diag = np.unique(offs, return_inverse=True)
        data = np.zeros((len(uniq), csr.n_rows), dtype=vals.dtype)
        np.add.at(data, (diag.reshape(-1), rows), vals)
        dev = csr.device if device is None else torch.device(device)
        return DIA(data=to_tensor(data, dev),
                   offsets=to_tensor(uniq.astype(np.int32), dev),
                   n_rows=csr.n_rows, n_cols=csr.n_cols)


def hyb_auto_threshold(row_lengths) -> int:
    """Default heavy-row cutoff: the median nnz/row (>= 2), as in the
    reference: power-law hubs and their tail go to the heavy stream, the
    light ELL slab stays as narrow as the typical row."""
    lens = np.asarray(row_lengths)
    if lens.size == 0:
        return 2
    return max(2, int(np.median(lens)))


@dataclasses.dataclass(frozen=True)
class HYB:
    """Hybrid row split: an ELL light partition over every row (heavy
    rows all padding there) plus the heavy rows' nonzeros as flat COO
    sorted by (column, row)."""

    data: torch.Tensor      # (n_rows, light_width) light values
    indices: torch.Tensor   # (n_rows, light_width) int32; padding -> col 0
    hvals: torch.Tensor     # (heavy_nnz,) column-sorted heavy values
    hrows: torch.Tensor     # (heavy_nnz,) int32 row per heavy nonzero
    hcols: torch.Tensor     # (heavy_nnz,) int32 column, ascending
    n_rows: int
    n_cols: int
    threshold: int
    light_width: int
    fill: float = 0.0

    @property
    def heavy_nnz(self) -> int:
        return int(self.hvals.shape[0])

    @staticmethod
    def from_csr(csr: CSR, threshold: int | None = None, fill: float = 0.0,
                 device=None) -> "HYB":
        lengths = csr.row_lengths()
        thr = hyb_auto_threshold(lengths) if threshold is None \
            else int(threshold)
        heavy_set = lengths > thr
        dev = csr.device if device is None else torch.device(device)

        cols = to_numpy(csr.indices).astype(np.int64)
        vals = to_numpy(csr.data)
        rows = _csr_rows(csr)
        is_heavy = heavy_set[rows]

        hr, hc, hv = rows[is_heavy], cols[is_heavy], vals[is_heavy]
        # ascending column, then row: np.lexsort((hr, hc)) as one key
        order = coo_order(hc, hr, csr.n_rows, dev)
        hr, hc, hv = hr[order], hc[order], hv[order]

        lr, lc, lv = rows[~is_heavy], cols[~is_heavy], vals[~is_heavy]
        light_lens = np.where(heavy_set, 0, lengths)
        width = int(light_lens.max()) if light_lens.size else 0
        data = np.full((csr.n_rows, width), fill, dtype=vals.dtype)
        idx = np.zeros((csr.n_rows, width), dtype=np.int32)
        if len(lr):
            light_ptr = np.zeros(csr.n_rows + 1, dtype=np.int64)
            light_ptr[1:] = np.cumsum(np.bincount(lr, minlength=csr.n_rows))
            inner = np.arange(len(lr), dtype=np.int64) - light_ptr[lr]
            data[lr, inner] = lv
            idx[lr, inner] = lc.astype(np.int32)
        return HYB(data=to_tensor(data, dev), indices=to_tensor(idx, dev),
                   hvals=to_tensor(hv, dev),
                   hrows=to_tensor(hr.astype(np.int32), dev),
                   hcols=to_tensor(hc.astype(np.int32), dev),
                   n_rows=csr.n_rows, n_cols=csr.n_cols, threshold=thr,
                   light_width=width, fill=float(fill))


__all__ = ["CSR", "ELL", "BELL", "DIA", "HYB", "csr_from_numpy",
           "hyb_auto_threshold", "array_fields", "coo_order"]
