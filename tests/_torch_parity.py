"""Shared inputs for the port's parity tests (`tests/test_torch_*.py`).

Every matrix and vector is made once with numpy from a seed and handed
to both packages: to `repro` as its own CSR, to `repro_torch` through
`csr_from_numpy` on the CPU.  Values are small integers stored as
float32, so every summation order is exact and plus-times results must
be bit-identical (the device of `tests/test_kernel_properties.py`);
or_and gets {0, 1} indicators and max_times nonnegative values, the
domains on which they are semirings.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.formats import CSR as TorchCSR, csr_from_numpy
from repro_torch.core.generators import fd_matrix, rmat_matrix
from repro_torch.testing import within_bf16_ulp  # noqa: F401 (re-export)

FAMILIES = ("fd", "rmat", "empty", "empty-rows", "single-dense-row")
SEMIRING_NAMES = ("plus_times", "min_plus", "or_and", "max_times")


def _structure(family: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if family in ("fd", "rmat"):
        # the port's generators: byte-identical to the reference's
        m = fd_matrix(max(n, 16), seed=seed, device="cpu") \
            if family == "fd" else rmat_matrix(
                1 << max(int(np.ceil(np.log2(max(n, 16)))), 4), seed=seed,
                device="cpu")
        rows = np.repeat(np.arange(m.n_rows, dtype=np.int64),
                         m.row_lengths())
        return rows, m.indices.numpy().astype(np.int64), m.n_rows
    if family == "empty":
        z = np.empty(0, dtype=np.int64)
        return z, z, n
    if family == "empty-rows":        # only even rows hold nonzeros
        rows = rng.integers(0, (n + 1) // 2, 2 * n) * 2
        return rows.astype(np.int64), rng.integers(0, n, 2 * n), n
    if family == "single-dense-row":  # one hub row over every column
        hub = int(rng.integers(0, n))
        rows = np.concatenate([np.full(n, hub), rng.integers(0, n, n // 2)])
        cols = np.concatenate([np.arange(n), rng.integers(0, n, n // 2)])
        return rows.astype(np.int64), cols.astype(np.int64), n
    raise ValueError(family)


def _int_coo(family: str, n: int, seed: int, sr_name: str):
    rows, cols, n_rows = _structure(family, n, seed)
    rng = np.random.default_rng(seed + 1)
    if sr_name == "or_and":
        vals = np.ones(rows.shape[0])
        x = rng.integers(0, 2, n_rows)
    elif sr_name == "max_times":
        vals = rng.integers(1, 9, rows.shape[0])
        x = rng.integers(0, 9, n_rows)
    else:
        vals = rng.integers(-8, 9, rows.shape[0])
        vals[vals == 0] = 1
        x = rng.integers(-8, 9, n_rows)
    return rows, cols, vals.astype(np.float32), n_rows, x.astype(np.float32)


def int_operands(family: str, n: int, seed: int, sr_name: str):
    """(reference CSR, x) with integer values in the semiring's domain."""
    from repro.core.formats import CSR

    rows, cols, vals, n_rows, x = _int_coo(family, n, seed, sr_name)
    return CSR.from_coo(rows, cols, vals, n_rows, n_rows), x


def port_int_operands(family: str, n: int, seed: int, sr_name: str,
                      device="cpu"):
    """The same operands as `int_operands`, as the port's CSR only (no
    JAX needed: the card's machine has none)."""
    rows, cols, vals, n_rows, x = _int_coo(family, n, seed, sr_name)
    return TorchCSR.from_coo(rows, cols, vals, n_rows, n_rows,
                             device=device), x


def port_csr(ref, device="cpu"):
    """The port's CSR over the reference's arrays."""
    return csr_from_numpy(np.asarray(ref.data), np.asarray(ref.indices),
                          np.asarray(ref.indptr), ref.n_rows, ref.n_cols,
                          device=device)


def same_csr(ref, port) -> bool:
    """Byte-identical arrays, dtypes included."""
    from repro_torch.device import to_numpy

    pairs = ((ref.data, port.data), (ref.indices, port.indices),
             (ref.indptr, port.indptr))
    return (ref.shape == port.shape and
            all(np.asarray(a).dtype == to_numpy(b).dtype and
                np.array_equal(np.asarray(a), to_numpy(b))
                for a, b in pairs))


def blocked_coo(n: int = 1024, n_blocks: int = 12, seed: int = 0):
    """(rows, cols, vals) of `n_blocks` dense 8x128 tiles at seeded
    block-aligned places: the scheme (and random stream) of
    `tests/test_auto_format.py:_blocked_matrix`, without JAX.  Tiles may
    overlap, which makes duplicate coordinates."""
    rng = np.random.default_rng(seed)
    rr, cc = np.meshgrid(np.arange(8), np.arange(128), indexing="ij")
    rows, cols = [], []
    for _ in range(n_blocks):
        r0 = int(rng.integers(0, n // 8)) * 8
        c0 = int(rng.integers(0, n // 128)) * 128
        rows.append((r0 + rr).ravel())
        cols.append((c0 + cc).ravel())
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = rng.normal(size=rows.shape[0]).astype(np.float32)
    return rows, cols, vals



def coo_of(csr):
    """(rows, cols, vals) of either package's CSR as numpy (int64, int64,
    float32), in CSR order."""
    from repro_torch.device import to_numpy

    indptr = to_numpy(csr.indptr).astype(np.int64)
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), np.diff(indptr))
    return (rows, to_numpy(csr.indices).astype(np.int64),
            to_numpy(csr.data).astype(np.float32))


def fresh_coords(csr, k: int, rng, avoid=()):
    """`k` coordinates absent from `csr` and from `avoid`, drawn with
    `rng` as `tests/test_streaming.py:_fresh_coords` draws them."""
    rows, cols, _ = coo_of(csr)
    present = set(zip(rows.tolist(), cols.tolist())) | set(avoid)
    out = []
    while len(out) < k:
        r, c = int(rng.integers(csr.n_rows)), int(rng.integers(csr.n_cols))
        if (r, c) not in present:
            out.append((r, c))
            present.add((r, c))
    return out
