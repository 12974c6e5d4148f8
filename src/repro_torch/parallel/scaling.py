"""Time model over a `ParallelRun`: latency, bandwidth, queueing and
the prefetcher shutoff.

Counterpart of `repro.parallel.scaling`.  Every thread's counters become
a `telemetry.topdown.TopdownStages` record; the machine roll-up
(`machine_stages`) adds the per-socket DRAM bandwidth floor as its own
stage, and the run's total cycles are defined as the staged sum, so the
stages sum bit-exactly to the total.  Two multithreaded effects:

  * a per-socket DRAM bandwidth floor, with a queueing term near
    saturation (the `backend_contention` stage);
  * the §IV-C prefetcher shutoff: a socket whose demand DRAM
    utilisation passes `machine.pf_shutoff_util` loses its threads'
    prefetchers, and the replay is repeated once without them.

`ParallelMetrics.gflops_est()` is the compiler's 'replay' score.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.telemetry import events as ev
# The single-core topdown model owns the calibration constants; sharing
# them (rather than re-stating the literals) keeps single-stream and
# multithreaded report rows comparable when either is re-tuned.
from repro_torch.telemetry.topdown import (COMPUTE_CPN, MECH_HIT_CYCLES,
                                     TopdownStages, machine_stages,
                                     stage_cycles)

from .engine import ParallelRun, ParallelSpec, partitioned_traces, replay_parallel

# DRAM utilization above which queueing delay inflates miss latency, and
# the inflation cap (mirrors cache_model's saturated-DRAM stall term).
QUEUE_UTIL_KNEE = 0.8
QUEUE_UTIL_CAP = 1.0


def thread_cycles(c, machine, nnz: int) -> Tuple[float, float]:
    """(compute_cycles, stall_cycles) for one thread's counters.

    A wrapper over `stage_cycles`; the staged record is the primary
    representation."""
    s = stage_cycles(c, machine, nnz)
    return s.retiring, s.backend_l2 + s.backend_llc + s.backend_dram


@dataclasses.dataclass(frozen=True)
class ParallelMetrics:
    """Headline numbers for one (matrix, partition, spec) replay."""

    threads: int
    time_s: float                 # total_cycles / freq (staged sum)
    lat_time_s: float             # slowest thread's cycle estimate
    bw_time_s: float              # slowest socket's DRAM-traffic floor
    dram_util: float              # bw_time / time (pre-queueing)
    demand_util: float            # demand-only DRAM utilization (max socket)
    dram_bytes: int               # total DRAM line traffic, all sockets
    pf_on_frac: float             # threads whose prefetcher stayed on
    nnz_per_thread: Tuple[int, ...]
    cycles_per_thread: Tuple[float, ...]
    l2_mpki: Tuple[float, ...]    # per-thread private-L2 demand MPKI
    llc_mpki: Tuple[float, ...]   # per-thread shared-LLC demand MPKI
    # staged attribution: machine-level roll-up (critical thread +
    # bandwidth-floor stage) and the per-thread records behind it.
    # total_cycles == stages.total_cycles() bit-exactly, and
    # time_s == total_cycles / (freq_ghz * 1e9).
    stages: TopdownStages = dataclasses.field(default_factory=TopdownStages)
    thread_stages: Tuple[TopdownStages, ...] = ()
    total_cycles: float = 0.0

    @property
    def l2_mpki_mean(self) -> float:
        return float(np.mean(self.l2_mpki)) if self.l2_mpki else 0.0

    @property
    def l2_mpki_max(self) -> float:
        return float(np.max(self.l2_mpki)) if self.l2_mpki else 0.0

    def gflops_est(self) -> float:
        nnz = sum(self.nnz_per_thread)
        return 2.0 * nnz / max(self.time_s, 1e-30) / 1e9

    def bound(self) -> str:
        """Dominant machine-level stage name (e.g. 'backend_dram')."""
        return self.stages.bound()


def parallel_metrics(run: ParallelRun, machine, nnz_per_thread,
                     queueing: bool = True) -> ParallelMetrics:
    """Roll a replay into the time model (deterministic, pure function).

    `queueing=False` drops the saturation queueing term (the
    `backend_contention` stage stays 0); `simulate_parallel` forwards
    `ParallelSpec.queueing` here.
    """
    lb = machine.line_bytes
    nnz_per_thread = tuple(int(v) for v in nnz_per_thread)
    freq = machine.freq_ghz * 1e9
    bw = machine.dram_bw_gbs * 1e9

    # SMT oversubscription: more threads than cores on a socket share issue
    # ports; the excess lands in the frontend stage (stalls still overlap
    # across SMT).
    socket_threads = {s: int(np.sum(run.sockets == s))
                      for s in set(run.sockets.tolist())}
    smt = [max(1.0, socket_threads[int(run.sockets[t])]
               / machine.cores_per_socket) for t in range(run.n_threads)]
    base = [stage_cycles(c, machine, nnz_per_thread[t], smt_factor=smt[t])
            for t, c in enumerate(run.counters)]

    # DRAM line traffic per socket: demand fills + prefetcher fills (the
    # prefetcher pulls from memory; lines already LLC-resident are a small
    # minority for these streams, so all fills are charged to the link).
    sockets = sorted(set(run.sockets.tolist()))
    demand_b = {s: 0 for s in sockets}
    total_b = {s: 0 for s in sockets}
    for t, c in enumerate(run.counters):
        s = int(run.sockets[t])
        demand_b[s] += c[ev.L3_DEMAND_MISS] * lb
        total_b[s] += (c[ev.L3_DEMAND_MISS] + c[ev.L2_PREFETCH_FILL]) * lb

    totals = [s.total_cycles() for s in base]
    lat_time = max(totals) / freq if totals else 0.0
    bw_time = max(total_b[s] / bw for s in sockets)
    time0 = max(lat_time, bw_time)
    dram_util = bw_time / max(time0, 1e-30)

    # queueing delay: near saturation, misses wait on the memory controller.
    # Normalized so the factor is 1.0 at the knee and grows continuously
    # (same 1/sqrt(headroom) shape as cache_model's saturated-DRAM term);
    # the inflation is attributed to the backend_contention stage.
    per_thread = base
    if queueing and dram_util > QUEUE_UTIL_KNEE:
        u = min(dram_util, QUEUE_UTIL_CAP)
        q = math.sqrt((1.05 - QUEUE_UTIL_KNEE) / (1.05 - u))
        per_thread = [stage_cycles(c, machine, nnz_per_thread[t],
                                   smt_factor=smt[t], queue_factor=q)
                      for t, c in enumerate(run.counters)]
        totals = [s.total_cycles() for s in per_thread]
        lat_time = max(totals) / freq if totals else 0.0

    # machine roll-up: critical thread + bandwidth-floor excess.  The
    # staged sum IS the total — time_s is derived from it, never the
    # other way around, which is what makes the accounting bit-exact.
    stages = machine_stages(per_thread, bw_time * freq)
    total_cycles = stages.total_cycles()
    time_s = total_cycles / freq
    demand_util = max(demand_b[s] / bw for s in sockets) / max(time_s, 1e-30)

    kinst = np.maximum(np.array(nnz_per_thread, dtype=np.float64)
                       * machine.instr_per_nnz / 1e3, 1e-12)
    l2_mpki = tuple(c[ev.L2_DEMAND_MISS] / k
                    for c, k in zip(run.counters, kinst))
    llc_mpki = tuple(c[ev.L3_DEMAND_MISS] / k
                     for c, k in zip(run.counters, kinst))
    return ParallelMetrics(
        threads=run.n_threads,
        time_s=time_s, lat_time_s=lat_time, bw_time_s=bw_time,
        dram_util=dram_util, demand_util=min(demand_util, 1.0),
        dram_bytes=int(sum(total_b.values())),
        pf_on_frac=float(np.mean(run.pf_enabled)) if run.n_threads else 0.0,
        nnz_per_thread=nnz_per_thread,
        cycles_per_thread=tuple(totals),
        l2_mpki=l2_mpki, llc_mpki=llc_mpki,
        stages=stages, thread_stages=tuple(per_thread),
        total_cycles=total_cycles,
    )


def simulate_parallel(csr, partition, machine, spec: ParallelSpec,
                      sweeps: int = 2,
                      traces: Optional[list] = None,
                      trace=None) -> Tuple[ParallelRun, ParallelMetrics]:
    """Replay a partitioned matrix and apply the prefetcher-shutoff
    fixed point.  Returns the final (run, metrics) pair.

    `traces` overrides the partition-derived traces (prebuilt ones can be
    shared across specs, like `sweep.run_point` does for mechanisms);
    `trace` is the lighter variant: one prebuilt *global* trace, sliced
    here per partition (what `scaling_sweep` passes from the matrix's
    cached plan so the thread axis replays one trace).
    """
    if traces is None:
        traces = partitioned_traces(csr, partition, machine, trace=trace)
    nnz = np.asarray(partition.nnz_per_part, dtype=np.int64)
    run = replay_parallel(traces, machine, spec, sweeps=sweeps)
    metrics = parallel_metrics(run, machine, nnz, queueing=spec.queueing)

    if spec.prefetcher and spec.pf_shutoff:
        # per-socket demand utilization decides which sockets lose their
        # prefetchers; one extra deterministic pass applies the decision
        lb, bw = machine.line_bytes, machine.dram_bw_gbs * 1e9
        shut = set()
        for s in sorted(set(run.sockets.tolist())):
            demand = sum(run.counters[t][ev.L3_DEMAND_MISS] * lb
                         for t in range(run.n_threads)
                         if int(run.sockets[t]) == s)
            if demand / bw / max(metrics.time_s, 1e-30) \
                    > machine.pf_shutoff_util:
                shut.add(s)
        if shut:
            mask = [int(run.sockets[t]) not in shut
                    for t in range(run.n_threads)]
            run = replay_parallel(traces, machine, spec, sweeps=sweeps,
                                  pf_enabled=mask)
            metrics = parallel_metrics(run, machine, nnz,
                                       queueing=spec.queueing)
    return run, metrics


__all__ = ["QUEUE_UTIL_KNEE", "QUEUE_UTIL_CAP", "thread_cycles",
           "ParallelMetrics", "parallel_metrics", "simulate_parallel"]
