"""Per-iteration cache behaviour of a whole analytic, from one plan
(counterpart of `repro.graph.telemetry`).

An iterative analytic replays the same SpMV demand stream once per
iteration, so its memory behaviour follows from the plan's memoised
`address_trace`: one hierarchy replays the trace `n_iters` times
against warm state, one `EventCounters` per iteration.  Iteration 1 is
the cold pass; later ones show what stays cached between SpMVs.  The
hierarchy is the simulated Sandy Bridge machine the reference models;
the replay is host-side Python over a numpy trace, whatever device the
plan lives on.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.cache_model import SANDY_BRIDGE, MachineModel
from repro_torch.telemetry.events import EventCounters
from repro_torch.telemetry.hierarchy import HierarchySpec
from repro_torch.telemetry.topdown import TopdownSummary, topdown_summary


def iteration_counters(plan, n_iters: int,
                       machine: MachineModel = SANDY_BRIDGE,
                       spec: Optional[HierarchySpec] = None
                       ) -> List[EventCounters]:
    """One `EventCounters` per iteration of an analytic run over `plan`
    (compiled with `keep_csr=True`, as the drivers compile), the
    hierarchy kept warm across iterations."""
    spec = spec if spec is not None else HierarchySpec()
    hier = spec.instantiate(machine)
    trace = plan.address_trace(machine).tolist()
    return [hier.replay(trace) for _ in range(max(int(n_iters), 1))]


def iteration_summaries(plan, n_iters: int,
                        machine: MachineModel = SANDY_BRIDGE,
                        spec: Optional[HierarchySpec] = None
                        ) -> List[TopdownSummary]:
    """`iteration_counters` as topdown report rows."""
    nnz = plan.csr.nnz if plan.csr is not None else plan.n_rows
    return [topdown_summary(c, machine, max(nnz, 1))
            for c in iteration_counters(plan, n_iters, machine, spec)]


def iteration_bounds(plan, n_iters: int,
                     machine: MachineModel = SANDY_BRIDGE,
                     spec: Optional[HierarchySpec] = None) -> List[str]:
    """The dominant bound category of each iteration (e.g. 'retiring',
    'backend_dram'); a label that changes along the list is a working
    set settling into cache."""
    return [s.bound() for s in iteration_summaries(plan, n_iters,
                                                   machine, spec)]


__all__ = ["iteration_counters", "iteration_summaries", "iteration_bounds"]
