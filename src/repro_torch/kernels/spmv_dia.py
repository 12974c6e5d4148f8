"""Banded (DIA) SpMV: the CUDA kernel's wrapper and its plain version.

Kernel: `csrc/spmv_dia.cu`, which replaces the TPU kernel
`repro/kernels/spmv_dia.py:spmv_dia_pallas`.  Plus-times only: DIA
stores absent entries as 0.0, which is absorbing only under ⊗ = *.

    y[i] = Σ_k band[k, i] * x[i + offsets[k]]     (x is 0 outside the matrix)

Both versions sum the diagonals in order k = 0 .. D-1 and round each
product and each sum on its own, so they agree bit for bit.
"""
from __future__ import annotations

import torch

from . import _build


def spmv_dia_plain(band: torch.Tensor, offsets: torch.Tensor,
                   x: torch.Tensor, n_cols: int) -> torch.Tensor:
    """Plain PyTorch version; `x` is (n_cols,) or a (k, n_cols) batch."""
    n_rows = band.shape[1]
    # zero halo wide enough for every offset: |off| < max(n_rows, n_cols)
    halo = max(n_rows, n_cols)
    xp = torch.nn.functional.pad(x[..., :n_cols], (halo, halo))
    rows = torch.arange(n_rows, device=band.device)
    y = torch.zeros(x.shape[:-1] + (n_rows,), dtype=band.dtype,
                    device=band.device)
    for k, off in enumerate(offsets.tolist()):
        y = y + band[k] * xp[..., rows + (off + halo)]
    return y


def spmv_dia(band: torch.Tensor, offsets: torch.Tensor, x: torch.Tensor,
             n_cols: int) -> torch.Tensor:
    """y = A @ x for A in DIA layout: band (D, n_rows) f32, offsets (D,)
    int32, x (>= n_cols,) f32.  CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    if not _build.on_cuda(band, offsets, x):
        return spmv_dia_plain(band, offsets, x, n_cols)
    _build.require(band, torch.float32, "band", 2)
    _build.require(offsets, torch.int32, "offsets", 1)
    _build.require(x, torch.float32, "x", 1)
    if x.shape[0] < n_cols or offsets.shape[0] != band.shape[0]:
        raise ValueError("spmv_dia: x or offsets do not match the band")
    n_rows, n_diags = band.shape[1], band.shape[0]
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return y
    fn = _build.function("spmv_dia", "spmv_dia_f32",
                         [_build.PTR] * 4 + [_build.INT] * 3 + [_build.PTR])
    with torch.cuda.device(x.device):
        rc = fn(band.data_ptr(), offsets.data_ptr(), x.data_ptr(),
                y.data_ptr(), n_rows, n_cols, n_diags, _build.stream_of(x))
    _build.check(rc, "spmv_dia", "spmv_dia launch")
    spmv_dia.launches += 1
    return y


spmv_dia.launches = 0
