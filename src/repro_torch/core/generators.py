"""The paper's two matrix families, byte-identical to the reference's.

Counterpart of `repro.core.generators`: the same numpy random streams
in the same order, so the same seed gives the same arrays -- including
the duplicate coordinates `fd_matrix` emits when the grid side
degenerates to 1 or 2 (ROADMAP C1).  The random draws are host-side
numpy; the CSR lands on `device` (R-MAT's edges, sort and sums run
there).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, stable_argsort, to_tensor

from .formats import CSR, csr_from_coo_tensors

# Graph500-style R-MAT quadrant probabilities.
RMAT_A, RMAT_B, RMAT_C, RMAT_D = 0.57, 0.19, 0.19, 0.05


def fd_matrix(n_rows: int, dtype=np.float32, seed: int = 0,
              device=None) -> CSR:
    """2-D 9-point-stencil FD matrix on a g x h periodic grid (g*h ==
    n_rows, g the largest divisor <= sqrt(n_rows)): nine nonzeros per
    row, the paper's three bands of three."""
    g = int(np.sqrt(n_rows))
    while n_rows % g != 0:
        g -= 1
    h = n_rows // g
    rng = np.random.default_rng(seed)

    node = np.arange(n_rows, dtype=np.int64)
    gi, gj = node // h, node % h
    rows, cols = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            rows.append(node)
            cols.append(((gi + di) % g) * h + (gj + dj) % h)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = rng.uniform(0.5, 1.5, size=rows.shape[0]).astype(dtype)
    return CSR.from_coo(rows, cols, vals, n_rows, n_rows, dtype=dtype,
                        device=device)


def rmat_edges(n_rows: int, n_edges: int, seed: int = 0,
               a: float = RMAT_A, b: float = RMAT_B,
               c: float = RMAT_C) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT edge list (int64 rows, cols), one quadrant draw per level."""
    rows, cols = _rmat_edges(n_rows, n_edges, seed, a, b, c,
                             torch.device("cpu"))
    return rows.numpy(), cols.numpy()


def _rmat_edges(n_rows, n_edges, seed, a, b, c, dev):
    """`rmat_edges` on `dev`: the host's uniform draws (the reference's
    stream), the quadrant bits there."""
    if n_rows <= 0 or n_rows & (n_rows - 1):
        raise ValueError("R-MAT needs a power-of-two dimension")
    levels = int(np.log2(n_rows))
    rng = np.random.default_rng(seed)
    rows = torch.zeros(n_edges, dtype=torch.int64, device=dev)
    cols = torch.zeros(n_edges, dtype=torch.int64, device=dev)
    ab, abc = a + b, a + b + c
    for _ in range(levels):
        r = torch.from_numpy(rng.random(n_edges)).to(dev)
        go_down = r >= ab                              # quadrants c, d
        go_right = ((r >= a) & (r < ab)) | (r >= abc)  # quadrants b, d
        rows = (rows << 1) | go_down
        cols = (cols << 1) | go_right
    return rows, cols


def rmat_matrix(n_rows: int, nnz_per_row: int = 8, dtype=np.float32,
                seed: int = 0, permute: bool = True, device=None) -> CSR:
    """R-MAT matrix with ~nnz_per_row nonzeros per row; duplicate edges
    summed in stream order; rows and columns randomly permuted.  The
    draws are the host's; the edges, the sort and the sums run on
    `device`."""
    dev = resolve_device(device)
    n_edges = n_rows * nnz_per_row
    rows, cols = _rmat_edges(n_rows, n_edges, seed, RMAT_A, RMAT_B, RMAT_C,
                             dev)
    if permute:
        rng = np.random.default_rng(seed + 1)
        rperm = to_tensor(rng.permutation(n_rows), dev)
        cperm = to_tensor(rng.permutation(n_rows), dev)
        rows = rperm[rows]
        cols = cperm[cols]
    rng2 = np.random.default_rng(seed + 2)
    vals = to_tensor(rng2.uniform(0.5, 1.5, size=n_edges).astype(dtype), dev)
    key = rows * n_rows + cols
    order = torch.sort(key, stable=True).indices
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    uniq = torch.ones(n_edges, dtype=torch.bool, device=dev)
    uniq[1:] = key[1:] != key[:-1]
    # duplicates summed in stream order, as the reference's np.add.at over
    # every edge sums them: the first edge of a key seeds its sum (0 + v
    # is v), the few repeats are added after it, one rank at a time
    start = torch.nonzero(uniq).squeeze(1)
    count = torch.diff(start, append=start.new_full((1,), n_edges))
    merged = vals[start]
    multi = torch.nonzero(count > 1).squeeze(1)
    first, reps, acc = start[multi], count[multi], merged[multi]
    for j in range(1, int(reps.max()) if multi.numel() else 1):
        more = reps > j
        acc[more] += vals[first[more] + j]
    merged[multi] = acc
    return csr_from_coo_tensors(rows[uniq], cols[uniq], merged, n_rows,
                                n_rows)


def banded_matrix(n_rows: int, bandwidth: int, nnz_per_row: int = 9,
                  dtype=np.float32, seed: int = 0, device=None) -> CSR:
    """Banded matrix with nonzeros uniform inside |c - r| <= bandwidth
    (clipped to the matrix), duplicates summed in stream order: the
    structure-sweep knob between FD-like and R-MAT-like."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    offs = rng.integers(-bandwidth, bandwidth + 1, size=rows.shape[0])
    cols = np.clip(rows + offs, 0, n_rows - 1)
    vals = rng.uniform(0.5, 1.5, size=rows.shape[0]).astype(dtype)
    key = rows * n_rows + cols
    order = stable_argsort(key, dev)
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    uniq = np.ones(len(key), dtype=bool)
    uniq[1:] = key[1:] != key[:-1]
    seg = np.cumsum(uniq) - 1
    mvals = np.zeros(int(seg[-1]) + 1, dtype=dtype)
    np.add.at(mvals, seg, vals)
    return CSR.from_coo(rows[uniq], cols[uniq], mvals, n_rows, n_rows,
                        dtype=dtype, device=dev)


def uniform_random_matrix(n_rows: int, nnz_per_row: int = 8,
                          dtype=np.float32, seed: int = 0,
                          device=None) -> CSR:
    """Uniform-random sparse matrix (no power law), duplicates kept:
    the control case."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, n_rows, size=rows.shape[0])
    vals = rng.uniform(0.5, 1.5, size=rows.shape[0]).astype(dtype)
    return CSR.from_coo(rows, cols, vals, n_rows, n_rows, dtype=dtype,
                        device=device)


def paper_sizes(max_log2_rows: int = 26, min_log2_rows: int = 11):
    """The paper's size sweep: 2^11 .. 2^26 rows."""
    return [2 ** k for k in range(min_log2_rows, max_log2_rows + 1)]


__all__ = ["fd_matrix", "rmat_edges", "rmat_matrix", "banded_matrix",
           "uniform_random_matrix", "paper_sizes",
           "RMAT_A", "RMAT_B", "RMAT_C", "RMAT_D"]
