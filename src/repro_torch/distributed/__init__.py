"""Row-parallel SpMV over a sequence of torch devices (counterpart of
`repro.distributed.spmv`, the hardware side of the `repro_torch.parallel`
simulation)."""
from .spmv import (RowMesh, default_row_partition, row_mesh,
                   spmv_row_sharded, spmv_row_sharded_prepared)

__all__ = ["RowMesh", "row_mesh", "default_row_partition",
           "spmv_row_sharded", "spmv_row_sharded_prepared"]
