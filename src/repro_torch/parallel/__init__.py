"""Multithreaded SpMV scaling engine (counterpart of `repro.parallel`).

N threads, each replaying its row-partition slice of the SpMV demand
stream through private L1/L2 caches while the threads of a socket
contend for one shared last-level cache and one DRAM link.  Host-side
Python, deterministic: the compiler's 'replay' oracle.

  engine    ParallelSpec, partitioned traces, the interleaved replay
  scaling   cycle / bandwidth / queueing time model, prefetcher shutoff
"""
from .engine import (ParallelRun, ParallelSpec, nnz_partitioned_traces,
                     partitioned_traces, replay_parallel)
from .scaling import (ParallelMetrics, parallel_metrics, simulate_parallel,
                      thread_cycles)

__all__ = [
    "ParallelRun", "ParallelSpec", "partitioned_traces",
    "nnz_partitioned_traces", "replay_parallel",
    "ParallelMetrics", "parallel_metrics", "simulate_parallel",
    "thread_cycles",
]
