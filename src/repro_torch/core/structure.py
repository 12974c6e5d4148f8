"""Structure metrics of a sparse matrix -- what `plan.choose_format` reads.

Counterpart of `repro.core.structure`: the same numpy arithmetic on the
same sampled column stream, so the report -- and therefore the format
the compiler picks -- is identical to the reference's, before and after
a reordering (`analyze_reorder`).  `x_access_stream` and
`reuse_distance_histogram` are the raw stream and its exact LRU stack
distances, host-side numpy as in the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.device import to_numpy

from .formats import CSR


@dataclasses.dataclass(frozen=True)
class StructureReport:
    n_rows: int
    nnz: int
    avg_nnz_per_row: float
    row_nnz_cv: float           # coefficient of variation: load-balance proxy
    bandwidth: int              # max |col - row|
    bandwidth_p95: int          # 95th percentile |col - row|
    n_distinct_offsets: int     # diagonals present (DIA viability)
    n_band_groups: int          # contiguous diagonal groups (FD: 3)
    spatial_locality: float     # frac of consecutive x-accesses within 1 line
    temporal_locality: float    # frac of x-accesses re-touching a recent line
    stream_servable: float      # frac servable by a K-stream next-line prefetcher
    block_density_8x128: float  # density within touched 8x128 blocks
    kind: str                   # 'banded' | 'blocked' | 'unstructured'

    def summary(self) -> str:
        return (
            f"{self.kind}: n={self.n_rows} nnz={self.nnz} "
            f"bw={self.bandwidth} bw95={self.bandwidth_p95} "
            f"bands={self.n_band_groups} "
            f"spatial={self.spatial_locality:.3f} "
            f"temporal={self.temporal_locality:.3f} "
            f"stream={self.stream_servable:.3f} "
            f"blockdens={self.block_density_8x128:.4f}"
        )


LINE_ELEMS = 8          # 64-byte line of f64 (paper) -- locality window
RECENT_WINDOW = 64      # lines considered "recent" for temporal locality
STREAM_WINDOW = 24      # accesses a 16-stream prefetcher can look back over


def x_access_stream(csr: CSR) -> np.ndarray:
    """The exact sequence of x-indices CSR SpMV touches (row-major),
    int64 on the host."""
    return to_numpy(csr.indices).astype(np.int64)


def analyze(csr: CSR, sample_rows: int | None = 65536,
            reordering=None) -> StructureReport:
    """Structure metrics of `csr` (after applying `reordering`, a
    `repro_torch.reorder.Reordering`, when given), from at most
    `sample_rows` rows taken as eight contiguous windows (the stream
    metrics need true sequences)."""
    if reordering is not None:
        csr = reordering.apply(csr)
    indptr = to_numpy(csr.indptr)
    lengths = np.diff(indptr)
    n_rows = csr.n_rows

    if sample_rows is not None and n_rows > sample_rows:
        n_chunks = 8
        chunk = sample_rows // n_chunks
        starts = np.linspace(0, n_rows - chunk, n_chunks).astype(np.int64)
        sel = np.concatenate([np.arange(s, s + chunk) for s in starts])
    else:
        sel = np.arange(n_rows, dtype=np.int64)

    cols_all = to_numpy(csr.indices)
    lo = indptr[sel]
    hi = indptr[sel + 1]
    seg_len = (hi - lo).astype(np.int64)
    total = int(seg_len.sum())
    pos = np.repeat(lo, seg_len) + (
        np.arange(total) - np.repeat(np.cumsum(seg_len) - seg_len, seg_len))
    cols = cols_all[pos].astype(np.int64) if total else np.zeros(0, np.int64)
    rows_rep = np.repeat(sel, seg_len) if total else np.zeros(0, np.int64)

    offs = cols - rows_rep
    bandwidth = int(np.abs(offs).max()) if offs.size else 0
    bandwidth_p95 = int(np.percentile(np.abs(offs), 95)) if offs.size else 0
    uniq_offs = np.unique(offs) if offs.size else np.zeros(0, np.int64)
    n_offsets = int(len(uniq_offs))
    if n_offsets:
        gaps = np.diff(np.sort(uniq_offs))
        n_band_groups = int(1 + np.sum(gaps > 2 * LINE_ELEMS))
    else:
        n_band_groups = 0

    lines = cols // LINE_ELEMS
    if lines.size > 1:
        spatial = float(np.mean(np.abs(np.diff(lines)) <= 1))
    else:
        spatial = 1.0
    temporal = _windowed_reuse(lines, RECENT_WINDOW)
    stream = _stream_servable(lines, STREAM_WINDOW)

    br = rows_rep // 8
    bc = cols // 128
    key = br * ((csr.n_cols // 128) + 2) + bc
    n_blocks = len(np.unique(key)) if key.size else 1
    block_density = float(cols.size) / (n_blocks * 8 * 128)

    avg_nnz = float(lengths.mean()) if lengths.size else 0.0
    cv = float(lengths.std() / max(avg_nnz, 1e-9)) if lengths.size else 0.0

    if n_offsets <= 32 and bandwidth_p95 <= 4 * LINE_ELEMS * 16:
        kind = "banded"
    elif block_density >= 0.05:
        kind = "blocked"
    else:
        kind = "unstructured"

    return StructureReport(
        n_rows=n_rows, nnz=csr.nnz, avg_nnz_per_row=avg_nnz, row_nnz_cv=cv,
        bandwidth=bandwidth, bandwidth_p95=bandwidth_p95,
        n_distinct_offsets=n_offsets, n_band_groups=n_band_groups,
        spatial_locality=spatial, temporal_locality=temporal,
        stream_servable=stream, block_density_8x128=block_density,
        kind=kind,
    )


@dataclasses.dataclass(frozen=True)
class StructureDelta:
    """Before/after structure comparison for one reordering."""

    strategy: str
    before: StructureReport
    after: StructureReport

    # the metrics a reordering is supposed to move, with the sign of "better"
    COMPARED = (("bandwidth", -1), ("bandwidth_p95", -1),
                ("n_distinct_offsets", -1), ("spatial_locality", +1),
                ("temporal_locality", +1), ("stream_servable", +1))

    def changes(self) -> dict:
        """metric -> (before, after) for every compared metric."""
        return {name: (getattr(self.before, name), getattr(self.after, name))
                for name, _ in self.COMPARED}

    def improved(self) -> bool:
        """Did any compared metric move in the better direction?"""
        return any(sign * (getattr(self.after, name) -
                           getattr(self.before, name)) > 0
                   for name, sign in self.COMPARED)

    def summary(self) -> str:
        parts = []
        for name, _ in self.COMPARED:
            b, a = getattr(self.before, name), getattr(self.after, name)
            fmt = "{:.0f}" if isinstance(b, (int, np.integer)) else "{:.3f}"
            parts.append(f"{name} {fmt.format(b)}->{fmt.format(a)}")
        return (f"{self.strategy}: kind {self.before.kind}->{self.after.kind} "
                + " ".join(parts))


def analyze_reorder(csr: CSR, reordering,
                    sample_rows: int | None = 65536) -> StructureDelta:
    """Before/after structure report pair for one reordering."""
    return StructureDelta(
        strategy=getattr(reordering, "strategy", "?"),
        before=analyze(csr, sample_rows=sample_rows),
        after=analyze(csr, sample_rows=sample_rows, reordering=reordering),
    )


def _stream_servable(lines: np.ndarray, window: int) -> float:
    """Fraction of accesses whose line is within +-1 of one of the
    previous `window` accesses' lines."""
    if lines.size < 2:
        return 1.0
    served = np.zeros(lines.size, dtype=bool)
    for k in range(1, window + 1):
        d = np.abs(lines[k:] - lines[:-k])
        served[k:] |= d <= 1
    served[0] = True
    return float(np.mean(served))


def _windowed_reuse(lines: np.ndarray, window: int) -> float:
    """Fraction of accesses whose line was seen within the last `window`
    accesses."""
    if lines.size < 2:
        return 1.0
    order = np.argsort(lines, kind="stable")
    sorted_lines = lines[order]
    same = sorted_lines[1:] == sorted_lines[:-1]
    prev_pos = np.full(lines.size, -10 ** 12, dtype=np.int64)
    prev_pos[order[1:][same]] = order[:-1][same]
    idx = np.arange(lines.size, dtype=np.int64)
    return float(np.mean((idx - prev_pos) <= window))


def reuse_distance_histogram(lines: np.ndarray):
    """Exact LRU stack distances via a Fenwick tree (O(m log m)): per
    access, the number of distinct lines touched since the previous
    access to the same line (-1 for a cold miss)."""
    m = lines.size
    tree = np.zeros(m + 1, dtype=np.int64)

    def bit_add(i, v):
        i += 1
        while i <= m:
            tree[i] += v
            i += i & (-i)

    def bit_sum(i):  # sum of [0, i)
        s = 0
        while i > 0:
            s += tree[i]
            i -= i & (-i)
        return s

    last = {}
    dists = np.empty(m, dtype=np.int64)
    for t in range(m):
        ln = lines[t]
        p = last.get(ln, -1)
        if p < 0:
            dists[t] = -1  # cold miss
        else:
            dists[t] = bit_sum(t) - bit_sum(p + 1)
            bit_add(p, -1)
        bit_add(t, 1)
        last[ln] = t
    return dists


__all__ = ["StructureReport", "StructureDelta", "analyze",
           "analyze_reorder", "x_access_stream", "reuse_distance_histogram",
           "LINE_ELEMS"]
