"""Containers, generators and structure analysis of the port
(counterparts of `repro.core`)."""
from .formats import CSR, DIA, ELL, HYB, csr_from_numpy, hyb_auto_threshold
from .generators import fd_matrix, rmat_edges, rmat_matrix
from .structure import StructureReport, analyze

__all__ = ["CSR", "ELL", "DIA", "HYB", "csr_from_numpy",
           "hyb_auto_threshold", "fd_matrix", "rmat_edges", "rmat_matrix",
           "StructureReport", "analyze"]
