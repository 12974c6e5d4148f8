"""Distribution layer: the mesh context and `shard_map` (`api`), sharding
rules, collectives, the pipeline schedule, fault tolerance, and the
row-parallel SpMV over a sequence of torch devices (counterpart of
`repro.distributed`; `distributed.spmv` is the hardware side of the
`repro_torch.parallel` simulation)."""
from . import api
from .spmv import (RowMesh, default_row_partition, row_mesh,
                   spmv_row_sharded, spmv_row_sharded_prepared)

__all__ = ["api", "RowMesh", "row_mesh", "default_row_partition",
           "spmv_row_sharded", "spmv_row_sharded_prepared"]
