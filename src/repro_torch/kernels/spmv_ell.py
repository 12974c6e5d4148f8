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
"""
from __future__ import annotations

import torch

from repro_torch.graph.semiring import Semiring

from . import _build


def spmv_ell_plain(data: torch.Tensor, idx: torch.Tensor, x: torch.Tensor,
                   sr: Semiring) -> torch.Tensor:
    """Plain PyTorch version on the slot-major (W, n_rows) layout."""
    y = sr.full((data.shape[1],), data)
    for w in range(data.shape[0]):
        y = sr.add(y, sr.mul(data[w], x[idx[w].long()]))
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


def spmv_ell_torch(ell, x: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Container oracle (the reference's `spmv_ell_semiring_jnp`): ⊕ over
    the slots of the (n_rows, W) container; `x` may be a (k, n) batch.
    The container's padding must already be absorbing."""
    if ell.data.shape[1] == 0:
        return sr.full(x.shape[:-1] + (ell.n_rows,), x)
    return sr.reduce(sr.mul(ell.data, x[..., ell.indices.long()]), dim=-1)
