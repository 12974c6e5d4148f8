"""ELLPACK SpMV under a semiring: the CUDA kernel's wrapper, its plain
version, and the container oracle.

Kernel: `csrc/spmv_ell.cu`, which replaces the TPU kernel
`repro/kernels/spmv_ell.py:spmv_ell_pallas`.  The prepared layout is
slot-major, (W, n_rows), so the threads of a warp read neighbouring
rows of one slot:

    y[r] = ⊕_{w < W} data[w, r] ⊗ x[idx[w, r]]     (identity when W == 0)

Padding slots hold the semiring's absorbing value.  Kernel and plain
version fold the slots in order w = 0 .. W-1 from the ⊕-identity and so
agree bit for bit.

Batched: `spmm_ell` (kernel `csrc/spmm_ell.cu`) computes the same
function for every row of a (k, n_cols) batch X in one launch, each
column folded in the single-vector kernel's order, so `Y[c]` equals
`spmv_ell(..., X[c], ...)` bit for bit; the plain version takes the
batch as it is.  How the kernel reads X follows the slab
(`gather_layout`): a banded slab reads X as it lies, a random one
gathers from its column-interleaved copy.
"""
from __future__ import annotations

import torch

from repro_torch.graph.semiring import Semiring, cached_on

from . import _build


def spmv_ell_plain(data: torch.Tensor, idx: torch.Tensor, x: torch.Tensor,
                   sr: Semiring) -> torch.Tensor:
    """Plain PyTorch version on the slot-major (W, n_rows) layout; `x`
    (n_cols,) or a (k, n_cols) batch, whose rows fold as each alone."""
    y = sr.full(x.shape[:-1] + (data.shape[1],), data)
    for w in range(data.shape[0]):
        y = sr.add(y, sr.mul(data[w], x[..., idx[w].long()]))
    return y


def spmv_ell(data: torch.Tensor, idx: torch.Tensor, x: torch.Tensor,
             sr: Semiring) -> torch.Tensor:
    """y = A (⊕,⊗) x for slot-major ELL: data (W, n_rows) f32, idx
    (W, n_rows) int32 columns of x.  CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    if not _build.on_cuda(data, idx, x):
        return spmv_ell_plain(data, idx, x, sr)
    _build.require(data, torch.float32, "data", 2)
    _build.require(idx, torch.int32, "idx", 2)
    _build.require(x, torch.float32, "x", 1)
    if idx.shape != data.shape:
        raise ValueError("spmv_ell: idx does not match data")
    width, n_rows = data.shape
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return y
    fn = _build.function("spmv_ell", "spmv_ell_f32",
                         [_build.PTR] * 4 + [_build.INT] * 3 + [_build.PTR])
    with torch.cuda.device(x.device):
        rc = fn(data.data_ptr(), idx.data_ptr(), x.data_ptr(), y.data_ptr(),
                n_rows, width, sr.code, _build.stream_of(x))
    _build.check(rc, "spmv_ell", "spmv_ell launch")
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0


def interleave_columns(X: torch.Tensor) -> torch.Tensor:
    """The (n_cols, k) column-interleaved copy of a (k, n_cols) batch
    that the batched kernels gather from: the k values of one column
    index side by side."""
    return X.t().contiguous()


#: `gather_layout` picks the direct read when the real (non-padding)
#: entries of a slot read, over each warp of 32 rows, at most this many
#: distinct 32-byte sectors of a column of X per entry.  Rows gathering
#: at random read one sector an entry (R-MAT's light slab: 0.98-1.0);
#: FD's stencil reads 0.146 and an RCM'd band 0.184 (2^12-2^18)
DIRECT_SECTORS_PER_ENTRY = 0.25


def gather_layout(data: torch.Tensor, idx: torch.Tensor, pad) -> str:
    """How `spmm_ell` reads X for the slot-major slab (data, idx), whose
    padding slots hold `pad`: "direct" -- X as it lies, (k, n_cols), when
    neighbouring rows gather neighbouring columns in a slot, so that a
    warp's 32 rows read a few 128-byte lines of each column -- or "xt",
    whole rows of the interleaved copy, when they gather at random."""
    width, n_rows = idx.shape
    real = data != pad
    n_real = int(real.sum())
    if n_real == 0:
        return "direct"
    n32 = -(-n_rows // 32) * 32
    sector = torch.where(real, torch.div(idx, 8, rounding_mode="floor"),
                         torch.full_like(idx, -1))
    sector = torch.nn.functional.pad(sector, (0, n32 - n_rows), value=-1)
    sector = sector.view(width, n32 // 32, 32).sort(dim=-1).values
    distinct = int(((sector[..., 1:] != sector[..., :-1])
                    & (sector[..., 1:] >= 0)).sum()
                   + (sector[..., 0] >= 0).sum())
    return "direct" if distinct <= DIRECT_SECTORS_PER_ENTRY * n_real \
        else "xt"


def spmm_ell(data: torch.Tensor, idx: torch.Tensor, X: torch.Tensor,
             sr: Semiring, xt=None, _gather=None) -> torch.Tensor:
    """Y[c] = A (⊕,⊗) X[c] for every row c of a (k, n_cols) batch, as
    (k, n_rows), on the slot-major layout of `spmv_ell`.  CUDA tensors
    launch the batched kernel once, whatever k is: it reads X as it lies
    or gathers from `xt` (`interleave_columns(X)`, made here when not
    given) as `gather_layout` chooses for the slab (kept with `idx`;
    `_gather` forces "direct" or "xt"); CPU tensors run the plain
    version."""
    if not _build.on_cuda(data, idx, X, xt):
        return spmv_ell_plain(data, idx, X, sr)
    _build.require(data, torch.float32, "data", 2)
    _build.require(idx, torch.int32, "idx", 2)
    _build.require(X, torch.float32, "X", 2)
    if idx.shape != data.shape:
        raise ValueError("spmm_ell: idx does not match data")
    width, n_rows = data.shape
    k, n_cols = X.shape
    Y = torch.empty((k, n_rows), dtype=torch.float32, device=X.device)
    if n_rows == 0 or k == 0:
        return Y
    gather = _gather or cached_on(
        idx, ("gather layout", sr.pad_value),
        lambda: gather_layout(data, idx, sr.pad_value))
    if gather not in ("direct", "xt"):
        raise ValueError(f"spmm_ell: unknown gather layout {gather!r}")
    src = X
    if gather == "xt":
        if xt is None:
            xt = interleave_columns(X)
        _build.require(xt, torch.float32, "xt", 2)
        if xt.shape != (n_cols, k):
            raise ValueError("spmm_ell: xt is not X's interleaved copy")
        src = xt
    fn = _build.function("spmm_ell", "spmm_ell_f32",
                         [_build.PTR] * 4 + [_build.INT] * 6 + [_build.PTR])
    with torch.cuda.device(X.device):
        rc = fn(data.data_ptr(), idx.data_ptr(), src.data_ptr(), Y.data_ptr(),
                n_rows, n_cols, width, k, gather == "direct", sr.code,
                _build.stream_of(X))
    _build.check(rc, "spmm_ell", "spmm_ell launch")
    spmm_ell.launches += 1
    return Y


spmm_ell.launches = 0


def spmv_ell_torch(ell, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Container oracle (the reference's `spmv_ell_semiring_jnp`): ⊕ over
    the slots of the (n_rows, W) container; `x` may be a (k, n) batch.
    The container's padding must already be absorbing."""
    if ell.data.shape[1] == 0:
        return sr.full(x.shape[:-1] + (ell.n_rows,), x)
    return sr.reduce(sr.mul(ell.data, x[..., ell.indices.long()]), dim=-1)
