"""Request/result records for the graph-analytics serving engine.

Counterpart of `repro.serve_graph.requests`, host-only and unchanged.

A serving request is `(graph_id, analytic, sources, params)` -- the
graph-analytics analogue of a token prompt: `graph_id` names a
registered adjacency (admission resolves it to a plan-cache fingerprint),
`analytic` picks a semiring iteration from `graph.drivers.ANALYTICS`,
`sources` are the seed vertices (one batch lane each), and `params`
forwards analytic-specific knobs (PageRank damping/tol).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class AnalyticRequest:
    req_id: int
    graph_id: str
    analytic: str
    sources: Tuple[int, ...] = ()
    params: Dict = dataclasses.field(default_factory=dict)
    max_iters: Optional[int] = None     # None -> engine default
    # bookkeeping, stamped by the engine
    arrived_step: int = 0
    admitted_step: int = -1
    finished_step: int = -1
    restarts: int = 0

    @property
    def lanes(self) -> int:
        """Batch lanes this request occupies while running.  One per
        source; sourceless analytics (classic PageRank, connected
        components) carry one state vector -> one lane.  An explicit
        empty source list is a zero-work request that still passes
        through the pipeline (admitted, finished, (0, n) values) --
        it is billed one lane for the step it occupies."""
        return max(1, len(self.sources))


@dataclasses.dataclass
class GraphMutation:
    """An edge-stream batch against a registered graph, interleaved with
    analytic requests.  `inserts` are (row, col, value) triples naming
    absent coordinates, `deletes` are (row, col) pairs naming present
    ones (change a weight by deleting + inserting in one batch) -- the
    `repro_torch.core.delta.EdgeDelta` contract.  The engine applies pending
    mutations at the top of the next step, in submit order: every
    analytic submitted after a mutation sees the mutated graph."""

    req_id: int
    graph_id: str
    inserts: Tuple = ()
    deletes: Tuple = ()
    arrived_step: int = 0


@dataclasses.dataclass
class MutationResult:
    """How one mutation moved each derived (graph, analytic) plan:
    `actions[analytic]` is 'overlay' (delta-overlaid plan installed
    warm), 'replan' (past budget / ineligible delete -- background
    re-plan parked, atomic swap on landing), 'rebase' (no plan was
    resident; next request compiles the materialized matrix cold), or
    'noop' (the analytic's operand was unchanged)."""

    req_id: int
    graph_id: str
    applied_step: int
    delta_nnz: int
    actions: Dict[str, str]


@dataclasses.dataclass
class AnalyticResult:
    req_id: int
    graph_id: str
    analytic: str
    values: np.ndarray          # (lanes, n) -- (0, n) for empty sources
    n_iters: int
    converged: bool
    arrived_step: int
    admitted_step: int
    finished_step: int
    restarts: int

    @property
    def latency_steps(self) -> int:
        """End-to-end steps from arrival to completion -- queueing,
        compile stalls, preemption restarts included."""
        return self.finished_step - self.arrived_step


__all__ = ["AnalyticRequest", "AnalyticResult", "GraphMutation",
           "MutationResult"]
