"""Containers, generators, structure analysis, edge deltas, the cache
model, partitioners and the per-call SpMV of the port (counterparts of
`repro.core`; its TPU traffic model `traffic` is not ported)."""
from . import cache_model, partition
from .cache_model import (SANDY_BRIDGE, CacheMetrics, MachineModel,
                          analytic_metrics)
from .delta import EdgeDelta, apply_delta, csr_diff, csr_lookup
from .formats import (BELL, CSR, DIA, ELL, HYB, csr_from_numpy,
                      hyb_auto_threshold)
from .generators import (banded_matrix, fd_matrix, paper_sizes, rmat_edges,
                         rmat_matrix, uniform_random_matrix)
from .spmv import auto_format, spmv
from .structure import (StructureDelta, StructureReport, analyze,
                        analyze_reorder)

__all__ = ["CSR", "ELL", "BELL", "DIA", "HYB", "csr_from_numpy",
           "hyb_auto_threshold", "fd_matrix", "rmat_edges", "rmat_matrix",
           "banded_matrix", "uniform_random_matrix", "paper_sizes",
           "StructureReport", "StructureDelta", "analyze",
           "analyze_reorder", "auto_format", "spmv", "EdgeDelta",
           "csr_lookup", "csr_diff", "apply_delta", "cache_model",
           "partition", "SANDY_BRIDGE", "CacheMetrics", "MachineModel",
           "analytic_metrics"]
