"""Deterministic multithreaded trace replay: private caches, shared LLC.

Counterpart of `repro.parallel.engine`.  One thread per `RowPartition`
part; each owns a private cache stack (optional L1, then L2 with the §V
mechanisms) and its own prefetcher, and the threads of a socket share
one LLC `CacheLevel`, so capacity contention between their streaming
matrix data and the shared x working set is simulated.  Accesses
interleave round-robin (one per live thread per round), so the same
partition and matrix give bit-identical per-thread counters.  With one
thread, no L1 and the machine's geometry the replay is
`telemetry.hierarchy.Hierarchy.default` on the full trace.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.device import to_numpy
from repro_torch.telemetry.events import EventCounters
from repro_torch.telemetry.hierarchy import (CacheLevel, Hierarchy, MissCache,
                                       SequentialPrefetcher, StreamBuffers,
                                       VictimCache, spmv_address_trace)


@dataclasses.dataclass(frozen=True)
class ParallelSpec:
    """Declarative description of the simulated multicore.

    Private-side geometry mirrors `HierarchySpec` (None -> machine
    default / fully associative); `llc_*` describes the per-socket
    shared last level.  `l1_bytes` adds an optional private first level
    in front of the L2 (the machine-geometry default omits it so the
    1-thread replay stays bit-compatible with the single-stream path).
    """

    l1_bytes: Optional[int] = None       # private L1; None -> no L1 level
    l1_ways: Optional[int] = None
    l2_bytes: Optional[int] = None       # private L2; None -> machine default
    ways: Optional[int] = None           # L2 associativity; None -> full
    llc_bytes: Optional[int] = None      # shared per-socket LLC
    llc_ways: Optional[int] = None
    prefetcher: bool = True              # per-thread next-line prefetcher
    pf_shutoff: bool = True              # model the paper's §IV-C shutoff
    queueing: bool = True                # DRAM queueing delay near saturation
    # §V mechanisms on the private L2 miss path (composable with the
    # telemetry mechanism axis)
    victim_entries: int = 0
    miss_entries: int = 0
    stream_buffers: int = 0
    stream_depth: int = 4

    def label(self) -> str:
        parts = []
        if self.l1_bytes:
            parts.append(f"l1-{self.l1_bytes // 1024}k")
        if self.l2_bytes:
            parts.append(f"l2-{self.l2_bytes // 1024}k")
        if self.llc_bytes:
            parts.append(f"llc-{self.llc_bytes // 1024}k")
        if self.victim_entries:
            parts.append(f"victim{self.victim_entries}")
        if self.stream_buffers:
            parts.append(f"stream{self.stream_buffers}x{self.stream_depth}")
        if not self.prefetcher:
            parts.append("nopf")
        return "+".join(parts) if parts else "machine"

    def _l2_mechanisms(self) -> List:
        mechs: List = []
        if self.victim_entries:
            mechs.append(VictimCache(self.victim_entries))
        if self.miss_entries:
            mechs.append(MissCache(self.miss_entries))
        if self.stream_buffers:
            mechs.append(StreamBuffers(self.stream_buffers,
                                       self.stream_depth))
        return mechs


@dataclasses.dataclass(frozen=True)
class ParallelRun:
    """Raw result of one interleaved replay (final warm sweep)."""

    counters: List[EventCounters]        # one per thread
    accesses: np.ndarray                 # per-thread trace lengths
    sockets: np.ndarray                  # thread -> socket id
    pf_enabled: np.ndarray               # per-thread prefetcher state (bool)

    @property
    def n_threads(self) -> int:
        return len(self.counters)


def partitioned_traces(csr, partition, machine,
                       trace: Optional[np.ndarray] = None) -> List[np.ndarray]:
    """Per-thread slices of the *global* SpMV address trace.

    All threads address one shared layout (same x/val/idx/ptr/y bases as
    `spmv_address_trace`), so val/idx/ptr/y regions of different threads
    are disjoint while every thread gathers from the same x region —
    the sharing pattern that makes the LLC contended.  Concatenating the
    slices in part order reproduces the single-stream trace exactly.

    `trace` overrides the freshly-computed global trace so one trace can
    be sliced under many partitions (e.g. a cached
    `SpmvPlan.address_trace` replayed across a whole thread axis).
    """
    if trace is None:
        trace = spmv_address_trace(csr, machine)
    indptr = to_numpy(csr.indptr).astype(np.int64)
    starts = np.asarray(partition.starts, dtype=np.int64)
    # row r starts at trace position 2*r + 3*indptr[r]
    cuts = 2 * starts + 3 * indptr[starts]
    return [trace[cuts[t]:cuts[t + 1]] for t in range(len(starts) - 1)]


def nnz_partitioned_traces(csr, partition, machine,
                           trace: Optional[np.ndarray] = None
                           ) -> List[np.ndarray]:
    """Per-thread slices of the global SpMV trace at *nonzero* cuts
    (`core.partition.NnzPartition`, the merge-CSR execution).

    A cut at nonzero c inside row r starts the slice at c's own trace
    position 2*(r+1) + 3*c (the carry-out merge reconciles the shared
    row); a cut on a row boundary starts at that row's header 2*r + 3*c,
    so trailing empty rows stay with the preceding thread.  Concatenating
    the slices in part order reproduces the single-stream trace exactly.
    """
    if trace is None:
        trace = spmv_address_trace(csr, machine)
    indptr = to_numpy(csr.indptr).astype(np.int64)
    cuts = np.asarray(partition.cuts, dtype=np.int64)
    # row containing each cut: last r with indptr[r] <= cut
    r = np.searchsorted(indptr, cuts, side="right") - 1
    on_boundary = indptr[r] == cuts
    pos = np.where(on_boundary, 2 * r + 3 * cuts, 2 * (r + 1) + 3 * cuts)
    # leading empty rows sit before the first cut's row: thread 0 owns them
    pos[0] = 0
    return [trace[pos[t]:pos[t + 1]] for t in range(len(cuts) - 1)]


def _socket_of(thread: int, machine) -> int:
    """Compact affinity with SMT-style wraparound: threads fill socket 0's
    cores first, then socket 1's, then oversubscribe from socket 0 again."""
    return (thread // machine.cores_per_socket) % max(machine.sockets, 1)


def replay_parallel(traces: Sequence, machine, spec: ParallelSpec,
                    sweeps: int = 2,
                    pf_enabled: Optional[Sequence[bool]] = None
                    ) -> ParallelRun:
    """Interleave the per-thread traces through private stacks + shared LLCs.

    `pf_enabled` masks individual threads' prefetchers (used by the
    §IV-C shutoff fixed point in `scaling.simulate_parallel`); `sweeps`
    repeats the whole interleaved replay against warm cache state and
    returns the counters of the final sweep, like `Hierarchy.run_trace`.
    """
    n_threads = len(traces)
    lb = machine.line_bytes
    if pf_enabled is None:
        pf_enabled = [spec.prefetcher] * n_threads

    sockets = np.array([_socket_of(t, machine) for t in range(n_threads)])
    llc_lines = (spec.llc_bytes or machine.l3_bytes) // lb
    shared_llc = {s: CacheLevel("L3", llc_lines, spec.llc_ways)
                  for s in sorted(set(sockets.tolist()))}

    hiers: List[Hierarchy] = []
    for t in range(n_threads):
        levels: List[CacheLevel] = []
        if spec.l1_bytes:
            levels.append(CacheLevel("L1", spec.l1_bytes // lb, spec.l1_ways))
        pf_level = len(levels)           # the prefetcher serves the L2
        levels.append(CacheLevel("L2", (spec.l2_bytes or machine.l2_bytes)
                                 // lb, spec.ways,
                                 mechanisms=spec._l2_mechanisms()))
        levels.append(shared_llc[int(sockets[t])])
        pf = (SequentialPrefetcher(machine.prefetch_streams)
              if pf_enabled[t] else None)
        hiers.append(Hierarchy(levels, pf, pf_level=pf_level))

    lists = [t.tolist() if isinstance(t, np.ndarray) else list(t)
             for t in traces]
    lens = [len(t) for t in lists]
    for _ in range(max(sweeps, 1)):
        counters = [EventCounters() for _ in range(n_threads)]
        accessors = [h.access for h in hiers]
        pos = [0] * n_threads
        left = sum(lens)
        while left:
            for t in range(n_threads):
                p = pos[t]
                if p < lens[t]:
                    accessors[t](lists[t][p], counters[t])
                    pos[t] = p + 1
                    left -= 1
    return ParallelRun(counters=counters,
                       accesses=np.array(lens, dtype=np.int64),
                       sockets=sockets,
                       pf_enabled=np.array(pf_enabled, dtype=bool))


__all__ = ["ParallelSpec", "ParallelRun", "partitioned_traces",
           "nnz_partitioned_traces", "replay_parallel"]
