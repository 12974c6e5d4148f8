"""repro_torch -- the SpMV system on PyTorch and hand-written CUDA for an
NVIDIA H100, beside the JAX reference package `repro`.

    core      CSR/ELL/BELL/DIA/HYB containers, FD and R-MAT generators,
              structure analysis (byte-identical to the reference's),
              the per-call `auto_format` / `spmv`, and the edge deltas
              of streaming graphs (`EdgeDelta`, `csr_diff`)
    reorder   RCM, degree sort, cache blocking and their chains
    kernels   seven CUDA kernels (DIA, ELL, padded CSR, segmented CSR,
              BELL, flash attention, paged attention), each with a plain
              PyTorch version beside it, the per-call `ops` wrappers and
              the attention oracles in `ref`
    plan      compile-once plans: analyze -> reorder -> format -> layout
              -> execute; overlaid plans (a plan plus an edge delta,
              served warm) and the cache's streaming lifecycle
    graph     semirings and the PageRank / BFS / SSSP / connected
              components drivers, with warm starts across deltas
    serve     the paged KV pool: block allocator, pool, token scatter
              and gather
    serve_graph  the analytics serving engine: admission over the plan
              cache, a lane-pool scheduler, coalesced SpMMs on the card
              and the mutation lifecycle of streaming graphs
    optim, data, train  the LM trainer: AdamW / Adafactor, the data
              pipeline and the train step (autograd over the plain
              attention), driven by `launch.train` with the restart
              supervisor of `distributed.fault`

Entry points run on the card unless the caller passes device="cpu".
"""
from .device import resolve_device

__all__ = ["resolve_device"]
