"""repro_torch -- the SpMV system on PyTorch and hand-written CUDA for an
NVIDIA H100, beside the JAX reference package `repro`.

    core      CSR/ELL/DIA/HYB containers, FD and R-MAT generators,
              structure analysis (byte-identical to the reference's)
    kernels   four CUDA kernels (DIA, ELL, padded CSR, segmented CSR),
              each with a plain PyTorch version beside it
    plan      compile-once plans: analyze -> format -> layout -> execute
    graph     semirings and the PageRank / BFS / SSSP / connected
              components drivers

Entry points run on the card unless the caller passes device="cpu".
"""
from .device import resolve_device

__all__ = ["resolve_device"]
