"""Device-memory data-movement model for SpMV (counterpart of
`repro.core.traffic`).

The paper's CPU metrics (cache miss rates) proxy for one quantity that
transfers to any accelerator: bytes moved per nonzero.  The paper's
proposals P1-P3 become software policies, each predicting bytes/nnz and
a bandwidth-roofline GFLOP/s:

  stream    : matrix tiles stream from device memory once (P1)
  gather    : each x access moves `gather_granularity` bytes (the
              analogue of the R-MAT demand-miss plateau)
  col-block : column stripes whose x slice is pinned on chip while the
              stripe's matrix sweeps once (P2 + P3)

The policies' formulas are the reference's.  `DeviceModel`'s defaults
are an NVIDIA H100 SXM's (data sheet figures): 3.35 TB/s device memory,
989 TFLOP/s dense bf16 on the tensor cores, 32-byte memory sectors, 25
GB/s per NVLink link and direction.  `vmem_bytes` -- the on-chip store a
pinned x stripe lives in -- stands for its 50 MB L2 cache: the stripe
must be shared by every SM that gathers from it, which the per-SM
shared memory (228 KB) is not.
"""
from __future__ import annotations

import dataclasses

from .formats import CSR


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str = "NVIDIA H100 SXM"
    peak_flops_bf16: float = 989e12       # dense bf16, tensor cores
    hbm_bw: float = 3.35e12               # device memory, bytes/s
    vmem_bytes: int = 50 * 1024 * 1024    # L2: where a pinned x stripe lives
    lane_bytes: int = 32                  # one memory sector
    gather_granularity: int = 32          # bytes moved per random x gather
    ici_bw_per_link: float = 25e9         # NVLink, bytes/s per link and way
    elem_bytes: int = 4                   # f32 values
    idx_bytes: int = 4


H100 = DeviceModel()


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    policy: str
    bytes_per_nnz: float
    hbm_bytes: float
    arithmetic_intensity: float      # flop / device-memory byte
    roofline_gflops: float           # min(peak, AI * BW) / 1e9
    vmem_resident_bytes: int
    x_reload_factor: float           # times each x byte is loaded on chip

    def summary(self) -> str:
        return (f"{self.policy:>10}: {self.bytes_per_nnz:7.2f} B/nnz  "
                f"AI={self.arithmetic_intensity:6.4f}  "
                f"roofline={self.roofline_gflops:8.2f} GFLOP/s  "
                f"x_reload={self.x_reload_factor:5.2f}")


def _matrix_stream_bytes(csr: CSR, dev: DeviceModel) -> float:
    """CSR arrays + y, streamed exactly once (P1)."""
    return (csr.nnz * (dev.elem_bytes + dev.idx_bytes)
            + (csr.n_rows + 1) * dev.idx_bytes
            + 2 * csr.n_rows * dev.elem_bytes)


def gather_policy(csr: CSR, dev: DeviceModel = H100) -> TrafficReport:
    """Per-nonzero random gather of x from device memory: each gather
    moves `gather_granularity` bytes of which 4 are useful -- the
    device's counterpart of the paper's R-MAT demand-miss regime."""
    mat = _matrix_stream_bytes(csr, dev)
    x_bytes = csr.nnz * dev.gather_granularity
    total = mat + x_bytes
    ai = 2.0 * csr.nnz / total
    return TrafficReport(
        policy="gather",
        bytes_per_nnz=total / csr.nnz,
        hbm_bytes=total,
        arithmetic_intensity=ai,
        roofline_gflops=min(dev.peak_flops_bf16, ai * dev.hbm_bw) / 1e9,
        vmem_resident_bytes=0,
        x_reload_factor=x_bytes / max(csr.n_cols * dev.elem_bytes, 1),
    )


def stream_policy(csr: CSR, bandwidth: int, dev: DeviceModel = H100
                  ) -> TrafficReport:
    """Banded/DIA policy (FD fast path): x windows stream alongside the
    matrix; each x byte crosses device memory once per diagonal *band
    group* that cannot share a window (FD's 3 bands -> x streams ~3x)."""
    n_windows = max(1, min(3, bandwidth // max(1, int(csr.n_rows ** 0.5))
                           + 1)) if bandwidth > 0 else 1
    mat = _matrix_stream_bytes(csr, dev)
    x_bytes = n_windows * csr.n_cols * dev.elem_bytes
    total = mat + x_bytes
    ai = 2.0 * csr.nnz / total
    return TrafficReport(
        policy="stream",
        bytes_per_nnz=total / csr.nnz,
        hbm_bytes=total,
        arithmetic_intensity=ai,
        roofline_gflops=min(dev.peak_flops_bf16, ai * dev.hbm_bw) / 1e9,
        vmem_resident_bytes=3 * int(csr.n_rows ** 0.5) * dev.elem_bytes,
        x_reload_factor=float(n_windows),
    )


def col_blocked_policy(csr: CSR, n_stripes: int | None = None,
                       dev: DeviceModel = H100) -> TrafficReport:
    """Column-blocked SpMV: the paper's P2+P3 realized in software.

    A is split into `n_stripes` column stripes; stripe s's x slice is
    loaded on chip once (`vmem_bytes`) and pinned while the stripe's
    nonzeros stream through, so x crosses device memory once per sweep
    and the partial y spills once per extra stripe.
    """
    if n_stripes is None:
        x_bytes_total = csr.n_cols * dev.elem_bytes
        n_stripes = max(1, -(-x_bytes_total // int(dev.vmem_bytes * 0.5)))
    mat = _matrix_stream_bytes(csr, dev)
    x_bytes = csr.n_cols * dev.elem_bytes           # once: stripes partition x
    y_spill = (n_stripes - 1) * 2 * csr.n_rows * dev.elem_bytes
    total = mat + x_bytes + y_spill
    ai = 2.0 * csr.nnz / total
    return TrafficReport(
        policy="col-block",
        bytes_per_nnz=total / csr.nnz,
        hbm_bytes=total,
        arithmetic_intensity=ai,
        roofline_gflops=min(dev.peak_flops_bf16, ai * dev.hbm_bw) / 1e9,
        vmem_resident_bytes=csr.n_cols * dev.elem_bytes // n_stripes,
        x_reload_factor=1.0,
    )


def bell_policy(density: float, csr: CSR, dev: DeviceModel = H100
                ) -> TrafficReport:
    """Blocked-ELL: random block gathers move useful 2-D tiles;
    bytes/nnz = block bytes / (true nnz per block) for the matrix and the
    gathered x tile (bn columns * 4 B each)."""
    bm, bn = 8, 128
    block_bytes = bm * bn * dev.elem_bytes
    nnz_per_block = max(density * bm * bn, 1e-9)
    mat = (block_bytes + dev.idx_bytes) / nnz_per_block * csr.nnz
    x_bytes = (bn * dev.elem_bytes) / nnz_per_block * csr.nnz
    y_bytes = 2 * csr.n_rows * dev.elem_bytes
    total = mat + x_bytes + y_bytes
    ai = 2.0 * csr.nnz / total
    return TrafficReport(
        policy="bell",
        bytes_per_nnz=total / csr.nnz,
        hbm_bytes=total,
        arithmetic_intensity=ai,
        roofline_gflops=min(dev.peak_flops_bf16, ai * dev.hbm_bw) / 1e9,
        vmem_resident_bytes=block_bytes * 2,
        x_reload_factor=x_bytes / max(csr.n_cols * dev.elem_bytes, 1),
    )


__all__ = ["DeviceModel", "H100", "TrafficReport", "gather_policy",
           "stream_policy", "col_blocked_policy", "bell_policy"]
