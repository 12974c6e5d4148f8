"""Geometry x mechanism x reordering x thread sweeps, and whole analytics
(counterpart of `repro.telemetry.sweep`).

The paper's §V question as a table: the same SpMV demand traces (FD and
R-MAT, several sizes) replayed through candidate hierarchies of the
simulated Sandy Bridge machine -- baseline, victim cache, miss cache,
stream buffers, combined -- with topdown metrics for each.  Every
number in a point is the simulated machine's (cycles, misses, estimated
GFLOPS), and equals the reference's for the same cell bit for bit.

  * `run_sweep` / `reorder_sweep` / `geometry_sweep`: one representative
    core replays its row slice (threads > 1 divide the L3 share);
  * `scaling_sweep`: every thread replays its `RowPartition` slice
    through `repro_torch.parallel` (private L1/L2, a shared contended
    LLC, a DRAM bandwidth model);
  * `graph_sweep`: a whole PageRank / BFS / SSSP run on the card through
    the kernels (`graph.DRIVERS`), then its plan's trace replayed once
    per executed iteration through a warm hierarchy.

Matrices are generated on `device` (None: the card); a sweep's own
plans (`_planned`) carry no kernel layout (`use_pallas=False`, the
reference's choice for address traces), and their traces come to the
host as numpy.  Each sweep is a thin client of `telemetry.runner`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cache_model import SANDY_BRIDGE, MachineModel
from repro_torch.core.formats import CSR
from repro_torch.device import resolve_device, to_numpy

from .events import EventCounters
from .hierarchy import HierarchySpec, spmv_address_trace
from .topdown import TopdownSummary, topdown_summary

# The paper's §V candidate mechanisms, by report label.
MECHANISMS: Dict[str, HierarchySpec] = {
    "baseline": HierarchySpec(),
    "victim-cache": HierarchySpec(victim_entries=64),
    "miss-cache": HierarchySpec(miss_entries=64),
    "stream-buffers": HierarchySpec(stream_buffers=8, stream_depth=4),
    "combined": HierarchySpec(victim_entries=64, stream_buffers=8,
                              stream_depth=4),
}

@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One (matrix, reorder, mechanism, geometry) cell of a sweep."""

    kind: str                 # 'fd' | 'rmat'
    log2n: int
    nnz: int
    threads: int
    mechanism: str
    spec: HierarchySpec
    counters: EventCounters
    summary: TopdownSummary
    reorder: str = "none"     # reordering strategy applied before tracing

    def row(self) -> List:
        return ([self.kind, self.log2n, self.nnz, self.threads,
                 self.reorder, self.mechanism]
                + [getattr(self.summary, f) for f in TopdownSummary.FIELDS]
                + [self.summary.bound()])

    @staticmethod
    def header() -> List[str]:
        return (["kind", "log2n", "nnz", "threads", "reorder", "mechanism"]
                + list(TopdownSummary.FIELDS) + ["bound"])


def _matrix(kind: str, n: int, seed: int, device) -> CSR:
    from repro_torch.core.generators import fd_matrix, rmat_matrix

    gen = fd_matrix if kind == "fd" else rmat_matrix
    return gen(n, seed=seed, device=device)


# Sweep plans pin a permuted CSR plus a memoised address trace each, so
# they get their own small cache, made on first use.
_PLAN_CACHE = None


def sweep_plan_cache():
    global _PLAN_CACHE
    if _PLAN_CACHE is None:
        from repro_torch.plan import PlanCache

        _PLAN_CACHE = PlanCache(max_plans=8)
    return _PLAN_CACHE


def _planned(base: CSR, strategy, device):
    """One cached plan per (matrix contents, reordering, device): the
    plan holds the permuted CSR and memoises its address trace, so the
    mechanism / thread / geometry axes re-permute nothing.  `strategy`
    is a `repro_torch.reorder` callable or None."""
    return sweep_plan_cache().get_or_compile(
        base, reorder=strategy, predictor="none", format="csr",
        use_pallas=False, keep_csr=True, device=str(device))


def _thread_slice(trace_csr: CSR, threads: int) -> Tuple[CSR, int]:
    """Representative core's row slice (contiguous, like rowblock_equal)."""
    if threads <= 1:
        return trace_csr, trace_csr.nnz
    n = trace_csr.n_rows
    rows_per = -(-n // threads)
    indptr = to_numpy(trace_csr.indptr)
    lo_r, hi_r = 0, min(rows_per, n)   # core 0 (rows are permuted: typical)
    lo_p, hi_p = int(indptr[lo_r]), int(indptr[hi_r])
    sub = CSR(
        data=trace_csr.data[lo_p:hi_p],
        indices=trace_csr.indices[lo_p:hi_p],
        indptr=trace_csr.indptr[lo_r:hi_r + 1] - lo_p,
        n_rows=hi_r - lo_r, n_cols=trace_csr.n_cols,
    )
    return sub, sub.nnz


def run_point(csr: CSR, spec: HierarchySpec,
              machine: MachineModel = SANDY_BRIDGE,
              threads: int = 1, sweeps: int = 2,
              trace=None) -> EventCounters:
    """Replay one matrix through one hierarchy; returns warm-sweep
    counters.  With threads > 1 the representative core's slice replays
    against an L3 share of capacity / threads-on-socket; `trace` (array
    or list of line ids) overrides the matrix-derived trace."""
    if threads > 1:
        tps = min(threads, machine.cores_per_socket)
        spec = dataclasses.replace(
            spec, l3_bytes=(spec.l3_bytes or machine.l3_bytes) // tps)
    if trace is None:
        if threads > 1:
            csr, _ = _thread_slice(csr, threads)
        trace = spmv_address_trace(csr, machine)
    return spec.instantiate(machine).run_trace(trace, sweeps=sweeps)


# ---------------------------------------------------------------------------
# Per-cell execution (the unit `telemetry.runner` shards and checkpoints).
# Every cell is a pure function of its arguments; the memos below only
# save work within one process.
# ---------------------------------------------------------------------------

_TRACE_MEMO: Dict[Tuple, Tuple] = {}
_TRACE_MEMO_MAX = 3


def _cell_inputs(kind: str, log2n: int, rlabel: str, strategy, threads: int,
                 seed: int, machine: MachineModel, device):
    """(sub_csr, sub_nnz, full_nnz, trace_list) for one mech cell."""
    key = (kind, log2n, rlabel, strategy, threads, seed, machine, device)
    hit = _TRACE_MEMO.get(key)
    if hit is not None:
        return hit
    base = _matrix(kind, 2 ** log2n, seed, device)
    p = _planned(base, strategy, device)
    full = p.csr
    if threads <= 1:
        sub, sub_nnz = full, full.nnz
        trace = p.address_trace(machine).tolist()
    else:
        sub, sub_nnz = _thread_slice(full, threads)
        trace = spmv_address_trace(sub, machine).tolist()
    if len(_TRACE_MEMO) >= _TRACE_MEMO_MAX:
        _TRACE_MEMO.pop(next(iter(_TRACE_MEMO)))
    out = (sub, sub_nnz, int(full.nnz), trace)
    _TRACE_MEMO[key] = out
    return out


def run_mech_cell(kind: str, log2n: int, rlabel: str, strategy,
                  threads: int, mech_label: str, spec: HierarchySpec,
                  machine: MachineModel = SANDY_BRIDGE,
                  sweeps: int = 2, seed: int = 0,
                  device=None) -> SweepPoint:
    """One (matrix, reorder, thread, mechanism) cell of `run_sweep`."""
    dev = resolve_device(device)
    sub, sub_nnz, full_nnz, trace = _cell_inputs(
        kind, log2n, rlabel, strategy, threads, seed, machine, dev)
    c = run_point(sub, spec, machine, threads=threads, sweeps=sweeps,
                  trace=trace)
    return SweepPoint(
        kind=kind, log2n=log2n, nnz=full_nnz, threads=threads,
        mechanism=mech_label, spec=spec, counters=c, reorder=rlabel,
        summary=topdown_summary(c, machine, sub_nnz))


def run_sweep(log2ns: Sequence[int] = (12, 14, 16),
              kinds: Sequence[str] = ("fd", "rmat"),
              mechanisms: Optional[Dict[str, HierarchySpec]] = None,
              machine: MachineModel = SANDY_BRIDGE,
              threads_list: Sequence[int] = (1,),
              sweeps: int = 2, seed: int = 0,
              reorderings: Optional[Dict] = None,
              workers: int = 1,
              ckpt_dir: Optional[str] = None,
              device=None) -> List[SweepPoint]:
    """The full grid, in sorted cell order: each (kind, size, reorder) is
    planned once and replayed across the mechanism and thread axes.
    `reorderings` maps a label to a `repro_torch.reorder` strategy (or
    None for the unpermuted matrix), applied before slicing and tracing.
    `workers` shards the cells across processes and `ckpt_dir`
    checkpoints and resumes them; the points are the same either way.
    `device` is where the matrices are generated, by name (None: the
    card)."""
    from . import runner

    mechanisms = mechanisms if mechanisms is not None else MECHANISMS
    reorderings = reorderings if reorderings is not None else {"none": None}
    cells = runner.mech_cells(log2ns=log2ns, kinds=kinds,
                              mechanisms=mechanisms,
                              threads_list=threads_list,
                              reorderings=reorderings)
    cfg = runner.SweepConfig(machine=machine, sweeps=sweeps, seed=seed,
                             mechanisms=dict(mechanisms),
                             reorderings=dict(reorderings),
                             device=runner.device_name(device))
    return runner.execute_cells(cells, cfg, workers=workers,
                                ckpt_dir=ckpt_dir)


def reorder_sweep(log2ns: Sequence[int] = (12,),
                  kinds: Sequence[str] = ("fd", "rmat"),
                  mechanisms: Optional[Dict[str, HierarchySpec]] = None,
                  reorderings: Optional[Dict] = None,
                  machine: MachineModel = SANDY_BRIDGE,
                  threads_list: Sequence[int] = (1,),
                  sweeps: int = 2, seed: int = 0,
                  device=None) -> List[SweepPoint]:
    """Every reordering strategy crossed with the baseline and stream
    buffers, for `report.reorder_gap_report`."""
    from repro_torch.reorder import STRATEGIES

    if mechanisms is None:
        mechanisms = {"baseline": MECHANISMS["baseline"],
                      "stream-buffers": MECHANISMS["stream-buffers"]}
    if reorderings is None:
        reorderings = dict(STRATEGIES)
        reorderings["none"] = None       # skip the identity permutation work
    return run_sweep(log2ns=log2ns, kinds=kinds, mechanisms=mechanisms,
                     machine=machine, threads_list=threads_list,
                     sweeps=sweeps, seed=seed, reorderings=reorderings,
                     device=device)


@dataclasses.dataclass(frozen=True)
class ScalingPoint:
    """One (matrix, reorder, thread-count) cell of a scaling sweep."""

    kind: str                 # 'fd' | 'rmat'
    log2n: int
    nnz: int
    threads: int
    reorder: str
    partition: str            # 'equal' | 'balanced' | 'merge'
    imbalance: float          # max/mean nnz over threads (1.0 = perfect)
    speedup: float            # time(1 thread) / time(threads), same cell
    efficiency: float         # speedup / threads
    metrics: object           # repro_torch.parallel.ParallelMetrics

    def row(self) -> List:
        m = self.metrics
        fr = m.stages.fractions()
        return ([self.kind, self.log2n, self.nnz, self.reorder,
                 self.partition, self.threads, self.speedup, self.efficiency,
                 m.time_s * 1e6, self.imbalance, m.l2_mpki_mean,
                 m.l2_mpki_max, float(np.mean(m.llc_mpki)), m.dram_util,
                 m.pf_on_frac, m.stages.bound(), fr["retiring"],
                 fr["frontend"], fr["backend_llc"], fr["backend_dram"],
                 fr["backend_contention"], fr["backend_bandwidth"]])

    @staticmethod
    def header() -> List[str]:
        return ["kind", "log2n", "nnz", "reorder", "partition", "threads",
                "speedup", "efficiency", "time_us", "imbalance",
                "l2_mpki_mean", "l2_mpki_max", "llc_mpki_mean", "dram_util",
                "pf_on", "bound", "retiring", "frontend", "llc_frac",
                "dram_frac", "contention", "bw_frac"]


# 1-thread reference times for the speedup columns, per process; another
# process recomputes the identical float.
_T1_MEMO: Dict[Tuple, float] = {}


def _scaling_run(kind: str, log2n: int, rlabel: str, strategy,
                 partition: str, threads: int, spec,
                 machine: MachineModel, sweeps: int, seed: int, device):
    from repro_torch.core.partition import (nnz_split, rowblock_balanced,
                                            rowblock_equal)
    from repro_torch.parallel import (nnz_partitioned_traces,
                                      simulate_parallel)

    base = _matrix(kind, 2 ** log2n, seed, device)
    p = _planned(base, strategy, device)
    csr = p.csr
    trace = p.address_trace(machine)
    if partition == "merge":
        part = nnz_split(csr, threads)
        slices = nnz_partitioned_traces(csr, part, machine, trace=trace)
        _, m = simulate_parallel(csr, part, machine, spec, sweeps=sweeps,
                                 traces=slices)
    else:
        part_fn = (rowblock_balanced if partition == "balanced"
                   else rowblock_equal)
        part = part_fn(csr, threads)
        _, m = simulate_parallel(csr, part, machine, spec, sweeps=sweeps,
                                 trace=trace)
    return csr, part, m


def run_scaling_cell(kind: str, log2n: int, rlabel: str, strategy,
                     partition: str, threads: int, spec=None,
                     machine: MachineModel = SANDY_BRIDGE,
                     sweeps: int = 2, seed: int = 0,
                     device=None) -> ScalingPoint:
    """One (matrix, reorder, partition, thread-count) cell of
    `scaling_sweep`, with its own 1-thread speedup reference."""
    from repro_torch.parallel import ParallelSpec

    dev = resolve_device(device)
    spec = spec if spec is not None else ParallelSpec()
    csr, part, m = _scaling_run(kind, log2n, rlabel, strategy, partition,
                                threads, spec, machine, sweeps, seed, dev)
    t1_key = (kind, log2n, rlabel, partition, spec, machine, sweeps, seed)
    t1_time = _T1_MEMO.get(t1_key)
    if t1_time is None:
        if part.n_parts == 1:
            t1_time = m.time_s
        else:
            _, _, m1 = _scaling_run(kind, log2n, rlabel, strategy, partition,
                                    1, spec, machine, sweeps, seed, dev)
            t1_time = m1.time_s
        _T1_MEMO[t1_key] = t1_time
    speedup = t1_time / max(m.time_s, 1e-30)
    threads_eff = part.n_parts        # partitioners cap parts at n_rows
    return ScalingPoint(
        kind=kind, log2n=log2n, nnz=csr.nnz, threads=threads_eff,
        reorder=rlabel, partition=partition, imbalance=part.imbalance(),
        speedup=speedup, efficiency=speedup / threads_eff, metrics=m)


def scaling_sweep(log2ns: Sequence[int] = (12,),
                  kinds: Sequence[str] = ("fd", "rmat"),
                  threads_list: Sequence[int] = (1, 2, 4, 8, 16, 32),
                  spec=None, machine: MachineModel = SANDY_BRIDGE,
                  partition: str = "equal",
                  reorderings: Optional[Dict] = None,
                  sweeps: int = 2, seed: int = 0,
                  workers: int = 1,
                  ckpt_dir: Optional[str] = None,
                  device=None) -> List[ScalingPoint]:
    """The thread axis: each (kind, size, reorder) partitioned per thread
    count ('equal' rows, 'balanced' on the nnz CDF, or 'merge': equal
    nonzero segments) and replayed through private caches and the
    shared, contended LLC; speedup against the same cell's 1-thread
    replay.  A thin client of `telemetry.runner`, like `run_sweep`."""
    from repro_torch.parallel import ParallelSpec

    from . import runner

    spec = spec if spec is not None else ParallelSpec()
    reorderings = reorderings if reorderings is not None else {"none": None}
    cells = runner.scaling_cells(log2ns=log2ns, kinds=kinds,
                                 threads_list=threads_list,
                                 partition=partition,
                                 reorderings=reorderings)
    cfg = runner.SweepConfig(machine=machine, sweeps=sweeps, seed=seed,
                             reorderings=dict(reorderings),
                             parallel_spec=spec,
                             device=runner.device_name(device))
    return runner.execute_cells(cells, cfg, workers=workers,
                                ckpt_dir=ckpt_dir)


@dataclasses.dataclass(frozen=True)
class GraphPoint:
    """One (matrix, analytic) cell of a graph sweep: a whole iterative
    analytic, with per-iteration cache behaviour from the plan's
    memoised trace (iteration 1 cold, later iterations warm)."""

    kind: str                 # 'fd' | 'rmat'
    log2n: int
    nnz: int                  # of the analytic's operand matrix
    analytic: str             # 'pagerank' | 'bfs' | 'sssp' | ...
    semiring: str
    n_iters: int
    converged: bool
    iters: Tuple              # TopdownSummary per iteration
    format_name: str = "csr"  # the plan's chosen container format

    @property
    def cold_cycles_per_nnz(self) -> float:
        return self.iters[0].cycles_per_nnz if self.iters else 0.0

    @property
    def warm_cycles_per_nnz(self) -> float:
        tail = self.iters[1:] or self.iters
        if not tail:
            return 0.0
        return float(np.mean([s.cycles_per_nnz for s in tail]))

    @property
    def total_cycles_per_nnz(self) -> float:
        """Whole-analytic cost: per-iteration cycles/nnz summed."""
        return float(sum(s.cycles_per_nnz for s in self.iters))

    def row(self) -> List:
        return [self.kind, self.log2n, self.nnz, self.analytic,
                self.semiring, self.format_name, self.n_iters,
                int(self.converged),
                self.cold_cycles_per_nnz, self.warm_cycles_per_nnz,
                self.total_cycles_per_nnz,
                self.iters[0].l2_mpki if self.iters else 0.0,
                self.iters[-1].l2_mpki if self.iters else 0.0,
                self.iters[0].bound() if self.iters else "",
                self.iters[-1].bound() if self.iters else ""]

    @staticmethod
    def header() -> List[str]:
        return ["kind", "log2n", "nnz", "analytic", "semiring", "format",
                "n_iters", "converged", "cold_cyc_nnz", "warm_cyc_nnz",
                "total_cyc_nnz", "l2_mpki_cold", "l2_mpki_warm",
                "bound_cold", "bound_warm"]


def graph_sweep(log2ns: Sequence[int] = (10,),
                kinds: Sequence[str] = ("fd", "rmat"),
                analytics: Sequence[str] = ("pagerank", "bfs", "sssp"),
                spec: Optional[HierarchySpec] = None,
                machine: MachineModel = SANDY_BRIDGE,
                seed: int = 0, max_iters: int = 64,
                format: Optional[str] = None,
                workers: int = 1,
                ckpt_dir: Optional[str] = None,
                device=None, cell_info: Optional[Dict] = None
                ) -> List[GraphPoint]:
    """Whole-analytic axis: each `graph.DRIVERS` analytic runs to
    convergence on `device` (None: the card) through the kernels, then
    its plan's trace replays once per executed iteration through a warm
    hierarchy.  BFS and SSSP start from the max-out-degree vertex;
    PageRank from a seeded random restart vector.  `format=None` lets
    each plan's structure analysis pick the container (R-MAT routes to
    'hyb'); a name pins every plan to it.  `cell_info` (a dict) receives
    per cell key the seconds and kernel launches of the cells this call
    ran (`runner.execute_cells`)."""
    from . import runner

    cells = runner.graph_cells(log2ns=log2ns, kinds=kinds,
                               analytics=analytics, format=format)
    cfg = runner.SweepConfig(machine=machine, seed=seed, hier_spec=spec,
                             max_iters=max_iters, graph_format=format,
                             device=runner.device_name(device))
    return runner.execute_cells(cells, cfg, workers=workers,
                                ckpt_dir=ckpt_dir, cell_info=cell_info)


def run_graph_cell(kind: str, log2n: int, analytic: str,
                   spec: Optional[HierarchySpec] = None,
                   machine: MachineModel = SANDY_BRIDGE,
                   seed: int = 0, max_iters: int = 64,
                   format: Optional[str] = None,
                   device=None) -> GraphPoint:
    """One (matrix, analytic) cell of `graph_sweep`: run the driver to
    convergence on `device`, then replay its plan's trace once per
    iteration."""
    res = run_graph_analytic(kind, log2n, analytic, seed=seed,
                             max_iters=max_iters, format=format,
                             device=device)
    return graph_point(kind, log2n, analytic, res, spec=spec,
                       machine=machine)


def run_graph_analytic(kind: str, log2n: int, analytic: str,
                       seed: int = 0, max_iters: int = 64,
                       format: Optional[str] = None, device=None):
    """The driver half of a graph cell: the analytic run to convergence
    on `device` from the reference's hub source / seeded restart
    vector; returns the driver's result."""
    from repro_torch.graph import DRIVERS

    dev = resolve_device(device)
    base = _matrix(kind, 2 ** log2n, seed, dev)
    source = int(np.argmax(np.diff(to_numpy(base.indptr))))
    r0 = np.random.default_rng(seed).uniform(
        0.5, 1.5, size=base.n_rows).astype(np.float32)
    driver = DRIVERS[analytic]
    if analytic in ("bfs", "sssp"):
        return driver(base, source, max_iters=max_iters, format=format,
                      device=dev)
    if analytic == "pagerank":
        return driver(base, r0=r0, max_iters=max_iters, format=format,
                      device=dev)
    return driver(base, max_iters=max_iters, format=format, device=dev)


def graph_point(kind: str, log2n: int, analytic: str, res,
                spec: Optional[HierarchySpec] = None,
                machine: MachineModel = SANDY_BRIDGE) -> GraphPoint:
    """The replay half of a graph cell: the plan's trace replayed once
    per iteration the driver ran."""
    from repro_torch.graph.telemetry import iteration_summaries

    iters = tuple(iteration_summaries(
        res.plan, res.n_iters, machine=machine, spec=spec))
    return GraphPoint(
        kind=kind, log2n=log2n, nnz=int(res.plan.csr.nnz),
        analytic=analytic, semiring=res.plan.semiring,
        n_iters=int(res.n_iters), converged=bool(res.converged),
        iters=iters, format_name=res.plan.format_name)


def geometry_sweep(log2n: int = 14,
                   kinds: Sequence[str] = ("fd", "rmat"),
                   l2_kb: Sequence[int] = (128, 256, 512),
                   ways: Sequence[Optional[int]] = (8, None),
                   machine: MachineModel = SANDY_BRIDGE,
                   sweeps: int = 2, seed: int = 0,
                   device=None) -> List[SweepPoint]:
    """Cache-size x associativity sweep at fixed size (mechanisms off)."""
    specs = {}
    for kb in l2_kb:
        for w in ways:
            wlab = "full" if w is None else f"{w}way"
            specs[f"l2-{kb}k-{wlab}"] = HierarchySpec(
                l2_bytes=kb * 1024, ways=w)
    return run_sweep(log2ns=(log2n,), kinds=kinds, mechanisms=specs,
                     machine=machine, sweeps=sweeps, seed=seed,
                     device=device)


__all__ = ["MECHANISMS", "SweepPoint", "run_point", "run_mech_cell",
           "run_sweep", "reorder_sweep", "ScalingPoint", "run_scaling_cell",
           "scaling_sweep", "GraphPoint", "graph_sweep", "run_graph_cell",
           "run_graph_analytic", "graph_point", "geometry_sweep",
           "sweep_plan_cache"]
