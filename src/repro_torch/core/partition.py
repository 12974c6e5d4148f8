"""Partitioners: row blocks and nonzero segments (thread parallelism)
and column stripes.

Counterpart of `repro.core.partition`, host-side numpy.  The paper
randomly permutes R-MAT rows and columns to equalise thread load;
`rowblock_balanced` gives the same guarantee deterministically by
splitting on the nnz CDF.  The compiler's replay oracle scores a
candidate under `rowblock_balanced` (`parallel.simulate_parallel`).
`sort_rows_by_nnz` wraps the port's `reorder.degree_sort`.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.device import to_numpy

from .formats import CSR


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """Row ranges [starts[i], starts[i+1]) per worker + their nnz counts."""
    starts: np.ndarray     # (parts+1,)
    nnz_per_part: np.ndarray

    @property
    def n_parts(self) -> int:
        return len(self.starts) - 1

    def imbalance(self) -> float:
        """max/mean nnz ratio -- 1.0 is perfect."""
        m = self.nnz_per_part.mean()
        return float(self.nnz_per_part.max() / max(m, 1e-9))


def rowblock_equal(csr: CSR, parts: int) -> RowPartition:
    """Equal row counts (what the paper's permuted matrices make safe).

    Every part is non-empty: row counts differ by at most one (an exact
    integer split; a float linspace's truncation can leave a part
    empty), and `parts > n_rows` is capped at one row per part
    (`n_parts` reports the effective count).
    """
    parts = max(1, min(int(parts), csr.n_rows))
    starts = (np.arange(parts + 1, dtype=np.int64) * csr.n_rows) // parts
    indptr = to_numpy(csr.indptr).astype(np.int64)
    nnz = indptr[starts[1:]] - indptr[starts[:-1]]
    return RowPartition(starts=starts, nnz_per_part=nnz)


def rowblock_balanced(csr: CSR, parts: int) -> RowPartition:
    """Equal nnz counts via CDF split (robust to unpermuted power laws)."""
    indptr = to_numpy(csr.indptr).astype(np.int64)
    targets = np.linspace(0, indptr[-1], parts + 1)
    starts = np.searchsorted(indptr, targets, side="left").astype(np.int64)
    starts[0], starts[-1] = 0, csr.n_rows
    starts = np.maximum.accumulate(starts)
    nnz = indptr[starts[1:]] - indptr[starts[:-1]]
    return RowPartition(starts=starts, nnz_per_part=nnz)


@dataclasses.dataclass(frozen=True)
class NnzPartition:
    """Flat-nonzero ranges [cuts[i], cuts[i+1]) per worker (merge-CSR
    style): cuts may fall mid-row, so a row crossing a boundary is shared
    and its partials reconciled by a carry-out merge.  Duck-typed with
    `RowPartition` where only `nnz_per_part` matters
    (`parallel.simulate_parallel`)."""
    cuts: np.ndarray       # (parts+1,) positions in the nonzero stream

    @property
    def n_parts(self) -> int:
        return len(self.cuts) - 1

    @property
    def nnz_per_part(self) -> np.ndarray:
        return np.diff(self.cuts)

    def imbalance(self) -> float:
        """max/mean nnz ratio -- by construction within 1 nonzero of 1.0."""
        m = self.nnz_per_part.mean()
        return float(self.nnz_per_part.max() / max(m, 1e-9))


def nnz_split(csr: CSR, parts: int) -> NnzPartition:
    """Equal nonzero segments regardless of row boundaries -- the
    partition the merge/segmented CSR kernel executes.  Unlike
    `rowblock_balanced` (which can still be skewed by a single hub row
    heavier than the target share), segment loads differ by at most one
    nonzero."""
    parts = max(1, min(int(parts), max(csr.nnz, 1)))
    cuts = (np.arange(parts + 1, dtype=np.int64) * csr.nnz) // parts
    return NnzPartition(cuts=cuts)


def col_stripes(csr: CSR, n_stripes: int) -> List[CSR]:
    """Split A into column stripes A = [A_0 | A_1 | ... ], so SpMV is
    y = sum_s A_s @ x_s (the paper's software-managed cache, P2+P3).
    Column indices are rebased to the stripe, so each stripe is a
    standalone (n_rows x stripe_width) CSR on A's device.
    """
    stripe_w = -(-csr.n_cols // n_stripes)
    indptr = to_numpy(csr.indptr).astype(np.int64)
    cols = to_numpy(csr.indices).astype(np.int64)
    vals = to_numpy(csr.data)
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), np.diff(indptr))
    out = []
    for s in range(n_stripes):
        lo, hi = s * stripe_w, min((s + 1) * stripe_w, csr.n_cols)
        m = (cols >= lo) & (cols < hi)
        out.append(CSR.from_coo(rows[m], cols[m] - lo, vals[m],
                                csr.n_rows, hi - lo,
                                dtype=vals.dtype, device=csr.device))
    return out


def sort_rows_by_nnz(csr: CSR) -> tuple[CSR, np.ndarray]:
    """Row permutation descending by nnz (SELL-style): groups similar-length
    rows so ELL padding within blocks is minimal.  Returns (A', perm) with
    A'[i] = A[perm[i]]; y' = A' x  =>  y = y'[inv_perm].

    A wrapper over `repro_torch.reorder.degree_sort`, which returns the
    richer `Reordering`.
    """
    from repro_torch.reorder import degree_sort

    r = degree_sort(csr, descending=True)
    return r.apply(csr), np.asarray(r.row_perm)


__all__ = ["RowPartition", "NnzPartition", "rowblock_equal",
           "rowblock_balanced", "nnz_split", "col_stripes",
           "sort_rows_by_nnz"]
