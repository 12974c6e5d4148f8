"""Containers, generators, structure analysis, edge deltas and the
per-call SpMV of the port (counterparts of `repro.core`)."""
from .delta import EdgeDelta, apply_delta, csr_diff, csr_lookup
from .formats import (BELL, CSR, DIA, ELL, HYB, csr_from_numpy,
                      hyb_auto_threshold)
from .generators import fd_matrix, rmat_edges, rmat_matrix
from .spmv import auto_format, spmv
from .structure import (StructureDelta, StructureReport, analyze,
                        analyze_reorder)

__all__ = ["CSR", "ELL", "BELL", "DIA", "HYB", "csr_from_numpy",
           "hyb_auto_threshold", "fd_matrix", "rmat_edges", "rmat_matrix",
           "StructureReport", "StructureDelta", "analyze",
           "analyze_reorder", "auto_format", "spmv", "EdgeDelta",
           "csr_lookup", "csr_diff", "apply_delta"]
