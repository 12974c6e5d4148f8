"""Row-parallel SpMV over a sequence of devices.

Counterpart of `repro.distributed.spmv`.  The reference's 1-D mesh (axis
'shards') is here a `RowMesh`: a sequence of torch devices, one per row
slab.  A device may appear more than once -- four slabs on one card, or
eight CPU slabs in the tests.  Every slab runs the ELL kernel
(`kernels.spmv_ell`) on its device with x replicated there; the y slabs
are cut to their parts' row counts and concatenated in slab order on
x's device, so no slab's sum meets another's (no cross-slab reduction,
no atomics).

    mesh = row_mesh(["cuda:0"] * 4)
    p = plan.compile(csr, mesh=mesh, reorder="none", predictor="none")
    y = p.execute(x)                       # four spmv_ell launches
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.formats import CSR
from repro_torch.core.partition import RowPartition, rowblock_equal
from repro_torch.device import resolve_device, to_numpy
from repro_torch.graph.semiring import PLUS_TIMES
from repro_torch.kernels import spmv_ell
from repro_torch.kernels._layout import (ShardedELL,          # noqa: F401
                                         prepare_ell_shards)

_AXIS = "shards"


@dataclasses.dataclass(frozen=True)
class RowMesh:
    """The devices of a row-sharded plan, slab p on `devices[p]`."""
    devices: Tuple[torch.device, ...]

    @property
    def shape(self):
        """{'shards': n}, as the reference's mesh gives its shape."""
        return collections.OrderedDict([(_AXIS, len(self.devices))])

    @property
    def n_shards(self) -> int:
        return len(self.devices)


def row_mesh(devices: Optional[Sequence] = None) -> RowMesh:
    """A mesh over the given devices (names or torch devices), or every
    visible card; a CUDA device without a card raises."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return RowMesh(devices=tuple(resolve_device(d) for d in devices))


def default_row_partition(csr: CSR, mesh: RowMesh) -> RowPartition:
    """`rowblock_equal` over the mesh's slabs, padded with trailing empty
    parts when there are more devices than rows (one slab per device)."""
    n_shards = mesh.n_shards
    if n_shards <= csr.n_rows:
        return rowblock_equal(csr, n_shards)
    starts = np.minimum(np.arange(n_shards + 1, dtype=np.int64), csr.n_rows)
    indptr = to_numpy(csr.indptr).astype(np.int64)
    return RowPartition(starts=starts,
                        nnz_per_part=indptr[starts[1:]] - indptr[starts[:-1]])


def spmv_row_sharded(csr: CSR, x, mesh: Optional[RowMesh] = None,
                     partition: Optional[RowPartition] = None,
                     bm: int = 128, reorder: str = "none",
                     predictor: str = "auto") -> torch.Tensor:
    """y = A @ x with rows sharded over the mesh's devices.  The sharded
    plan is cached in `repro_torch.plan.DEFAULT_CACHE` by matrix
    contents, mesh and partition, so repeated multiplies pack the slabs
    once.  `reorder='auto'` lets the compiler's scoring pick the order."""
    from repro_torch import plan as _plan

    mesh = mesh if mesh is not None else row_mesh()
    n_shards = mesh.n_shards
    if partition is None:
        partition = default_row_partition(csr, mesh)
    if partition.n_parts != n_shards:
        raise ValueError(f"partition has {partition.n_parts} parts for "
                         f"{n_shards} devices on axis '{_AXIS}'")
    if reorder == "none":
        predictor = "none"     # nothing to score
    p = _plan.DEFAULT_CACHE.get_or_compile(
        csr, mesh=mesh, partition=partition, bm=bm, reorder=reorder,
        predictor=predictor, keep_csr=False)
    return p.execute(x)


def spmv_row_sharded_prepared(prep: ShardedELL, x: torch.Tensor,
                              mesh: RowMesh) -> torch.Tensor:
    """One `spmv_ell` per slab on its device (x copied there once per
    device), y slabs cut to their parts and concatenated on x's device."""
    if x.dim() != 1 or x.shape[0] != prep.n_cols:
        raise ValueError(f"x must have shape ({prep.n_cols},), got "
                         f"{tuple(x.shape)}")
    on: dict = {}
    parts = []
    for p, (data, idx) in enumerate(prep.slabs(mesh.devices)):
        dev = data.device
        if dev not in on:
            on[dev] = x.to(dev)
        y = spmv_ell(data, idx, on[dev], PLUS_TIMES)
        rows = int(prep.starts[p + 1] - prep.starts[p])
        parts.append(y[:rows].to(x.device))
    return torch.cat(parts)[: prep.n_rows]


__all__ = ["RowMesh", "row_mesh", "default_row_partition",
           "spmv_row_sharded", "spmv_row_sharded_prepared", "ShardedELL",
           "prepare_ell_shards"]
