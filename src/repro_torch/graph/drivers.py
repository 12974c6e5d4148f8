"""Iterative graph analytics on compiled plans, on the card.

Counterpart of `repro.graph.drivers` for the blocking drivers:

    pagerank              plus_times  on the column-stochastic transpose
    bfs                   or_and      frontier propagation (hop depths)
    sssp                  min_plus    Bellman-Ford relaxation
    connected_components  min_plus    label propagation (zero weights)

Each analytic is an operand builder (host-side, the reference's numpy),
a stepper (the per-iteration state machine) and the SpMV, which the
driver owns: single-source runs call `plan.execute` -- one hand-written
kernel launch per iteration on a CUDA plan -- and multi-source runs
batch through `plan.execute_many` -- one launch of each batched kernel
an iteration on an ELL, HYB or segmented-CSR plan, whatever the number
of sources.  The steppers keep their state as
tensors on the plan's device and read one scalar back per iteration,
the progress value that decides convergence.

Graph convention: A[i, j] != 0 is an edge i -> j; SpMV pulls along rows,
so push-style traversals run on the transpose.  `device=None` means the
card; pass device="cpu" for the plain versions on the CPU.  Every driver
takes `reorder=` (a strategy name, callable or `Reordering`) and passes
it to the plan, whose iterations then run on the permuted operand while
the values stay in the original vertex order.

Warm starts: after an edge delta, `warm_start_params` says whether an
analytic may resume from its converged values (`r0` for PageRank, `d0`
for SSSP, `l0` for connected components; the reference's rules) or
must re-seed; warm state arrives as numpy and goes onto the plan's
device.  The steppers are also what `repro_torch.serve_graph` batches
across concurrent requests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.formats import CSR
from repro_torch.device import resolve_device, to_numpy, unique_inverse

from .semiring import MIN_PLUS, OR_AND, PLUS_TIMES, Semiring


@dataclasses.dataclass
class GraphResult:
    """values (numpy; (k, n) for multi-source), SpMV iterations run,
    whether the fixpoint / tolerance was reached, one progress scalar
    per iteration, the plan the iterations ran through, and the host
    wall seconds of the iteration loop (each iteration ends in its one
    device read, so this covers the device work)."""

    values: np.ndarray
    n_iters: int
    converged: bool
    history: List[float]
    plan: object
    iter_s: float = 0.0


def transpose_csr(csr: CSR) -> CSR:
    """A^T as a canonically sorted CSR on the same device."""
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64),
                     csr.row_lengths())
    data = to_numpy(csr.data)
    return CSR.from_coo(to_numpy(csr.indices).astype(np.int64), rows, data,
                        csr.n_cols, csr.n_rows, dtype=data.dtype,
                        device=csr.device)


def _require_square(adj: CSR, who: str) -> int:
    if adj.n_rows != adj.n_cols:
        raise ValueError(f"{who} needs a square adjacency, "
                         f"got {adj.n_rows}x{adj.n_cols}")
    return adj.n_rows


def check_sources(source, n: int, who: str = "analytic") -> np.ndarray:
    """Validate and normalize a source spec to an int64 array."""
    sources = np.atleast_1d(np.asarray(source, dtype=np.int64))
    if sources.ndim != 1:
        raise ValueError(f"{who} sources must be a scalar or 1-D sequence, "
                         f"got shape {sources.shape}")
    if sources.size and (sources.min() < 0 or sources.max() >= n):
        bad = sources[(sources < 0) | (sources >= n)]
        raise ValueError(f"{who} sources out of range for n={n}: "
                         f"{bad.tolist()}")
    return sources


def plan_options(semiring, *, reorder="none", predictor="none", format=None,
                 use_pallas=True, device=None) -> Dict:
    """The exact compile-option dict the drivers use.  Without `device`
    it is the reference's dict, so `PlanCache.key_for` gives the
    reference's key; a given device joins the key.  `interpret=None` is
    the reference's Pallas flag: it is only keyed, never compiled."""
    name = semiring.name if isinstance(semiring, Semiring) else str(semiring)
    opts = dict(reorder=reorder, predictor=predictor, semiring=name,
                use_pallas=use_pallas, interpret=None, keep_csr=True)
    if format is not None:
        opts["format"] = format
    if device is not None:
        opts["device"] = str(torch.device(device))
    return opts


def _plan_device(device):
    """Resolve `device` up front, so a missing card raises before any
    host work; None stays None, keeping the reference's cache key."""
    dev = resolve_device(device)
    return None if device is None else dev


def _graph_plan(matrix: CSR, semiring, *, reorder, plan_cache, format,
                use_pallas, device):
    from repro_torch import plan as _plan

    cache = plan_cache if plan_cache is not None else _plan.DEFAULT_CACHE
    return cache.get_or_compile(matrix, **plan_options(
        semiring, reorder=reorder, format=format, use_pallas=use_pallas,
        device=device))


# ---------------------------------------------------------------------------
# Operand builders: adjacency -> the matrix the iteration multiplies
# ---------------------------------------------------------------------------

def pagerank_operand(adj: CSR) -> Tuple[CSR, Dict]:
    """Column-stochastic transpose P[j, i] = 1/out_deg[i] per edge i -> j,
    plus the dangling-vertex mask the iteration redistributes."""
    n = _require_square(adj, "pagerank")
    out_deg = adj.row_lengths().astype(np.float32)
    rows = np.repeat(np.arange(n, dtype=np.int64), adj.row_lengths())
    cols = to_numpy(adj.indices).astype(np.int64)
    stoch = CSR.from_coo(cols, rows, 1.0 / np.maximum(out_deg[rows], 1.0),
                         n, n, device=adj.device)
    return stoch, {"dangling": (out_deg == 0).astype(np.float32)}


def bfs_operand(adj: CSR) -> Tuple[CSR, Dict]:
    """0/1 pattern of A^T."""
    n = _require_square(adj, "bfs")
    at = transpose_csr(adj)
    return CSR(data=torch.ones_like(at.data), indices=at.indices,
               indptr=at.indptr, n_rows=n, n_cols=n), {}


def sssp_operand(adj: CSR) -> Tuple[CSR, Dict]:
    _require_square(adj, "sssp")
    return transpose_csr(adj), {}


def cc_operand(adj: CSR) -> Tuple[CSR, Dict]:
    """Symmetrized, deduplicated zero-weight pattern."""
    n = _require_square(adj, "connected_components")
    if n > (1 << 24):
        raise ValueError(
            f"connected_components labels are f32 vertex ids, which are "
            f"only injective up to 2^24; got n={n}")
    rows = np.repeat(np.arange(n, dtype=np.int64), adj.row_lengths())
    cols = to_numpy(adj.indices).astype(np.int64)
    keys, _ = unique_inverse(
        np.concatenate([rows * n + cols, cols * n + rows]), adj.device)
    return CSR.from_coo(keys // n, keys % n,
                        np.zeros(keys.size, dtype=np.float32), n, n,
                        device=adj.device), {}


# ---------------------------------------------------------------------------
# Steppers: frontier -> SpMV -> advance, state on the plan's device
# ---------------------------------------------------------------------------

def _source_rows(sources: np.ndarray, n: int, fill: float, hit: float,
                 device) -> torch.Tensor:
    t = torch.full((len(sources), n), fill, dtype=torch.float32,
                   device=device)
    if len(sources):
        t[torch.arange(len(sources), device=device),
          torch.as_tensor(sources, device=device)] = hit
    return t


class PageRankStepper:
    """Power iteration on the stochastic transpose, k lanes; a source lane
    teleports to its seed (personalized PageRank), no sources means one
    uniform lane."""

    def __init__(self, plan, aux: Dict, sources=(), damping: float = 0.85,
                 tol: float = 1e-8, r0=None):
        n, dev = plan.n_cols, plan.device
        sources = check_sources(sources, n, "pagerank") if len(
            np.atleast_1d(sources)) else np.array([], dtype=np.int64)
        self.plan, self.damping, self.tol = plan, float(damping), float(tol)
        self.dangling = torch.as_tensor(aux["dangling"], device=dev)
        if sources.size:
            self.teleport = _source_rows(sources, n, 0.0, 1.0, dev)
        else:
            self.teleport = torch.full((1, n), 1.0 / max(n, 1),
                                       dtype=torch.float32, device=dev)
        if r0 is not None:
            r = torch.as_tensor(np.asarray(r0, np.float32), device=dev)
            r = r.reshape(1, n) if r.dim() == 1 else r
            if r.shape != self.teleport.shape:
                raise ValueError(
                    f"r0 shape {tuple(r.shape)} does not match the "
                    f"{tuple(self.teleport.shape)} lane layout")
            r = r / torch.clamp(r.sum(dim=1, keepdim=True), min=1e-30)
        else:
            r = self.teleport
        self.r = r
        self.k = int(r.shape[0])
        self.done = self.k == 0

    def frontier(self) -> torch.Tensor:
        return self.r

    def advance(self, y: torch.Tensor) -> float:
        leaked = self.r @ self.dangling                       # (k,)
        r_new = (self.damping * (y + leaked[:, None] * self.teleport)
                 + (1.0 - self.damping) * self.teleport)
        resid = (r_new - self.r).abs().sum(dim=1)
        self.r = r_new
        worst = float(resid.max()) if self.k else 0.0     # the one read
        self.done = worst < self.tol
        return worst

    def values(self) -> np.ndarray:
        return to_numpy(self.r)


class BfsStepper:
    """or_and frontier propagation; `values()[l, v]` is v's hop depth
    from lane l's source (+inf if unreachable)."""

    def __init__(self, plan, aux: Dict, sources=(), **_):
        n, dev = plan.n_cols, plan.device
        sources = check_sources(sources, n, "bfs")
        self.plan, self.k, self.level = plan, len(sources), 0
        self.depth = _source_rows(sources, n, np.inf, 0.0, dev)
        self.front = _source_rows(sources, n, 0.0, 1.0, dev)
        self.done = self.k == 0

    def frontier(self) -> torch.Tensor:
        return self.front

    def advance(self, y: torch.Tensor) -> float:
        self.level += 1
        reached = (y > 0.0) & torch.isinf(self.depth)
        self.depth.masked_fill_(reached, float(self.level))
        self.front = reached.to(torch.float32)
        count = int(reached.sum())                         # the one read
        self.done = count == 0
        return float(count)

    def values(self) -> np.ndarray:
        return to_numpy(self.depth)


def _warm(values, shape, device) -> torch.Tensor:
    """Prior values (numpy or array-like) as a float32 tensor of `shape`
    on `device`."""
    return torch.as_tensor(np.asarray(values, np.float32).reshape(shape),
                           device=device)


class SsspStepper:
    """min_plus Bellman-Ford relaxation, k source lanes.  `d0` (k, n)
    warm-starts from prior distances: after insert-only deltas they are
    valid upper bounds, so relaxation resumes from them; deletes can
    raise true distances and need a re-seed (`warm_start_params`)."""

    def __init__(self, plan, aux: Dict, sources=(), d0=None, **_):
        n, dev = plan.n_cols, plan.device
        sources = check_sources(sources, n, "sssp")
        self.plan, self.k = plan, len(sources)
        self.dist = _source_rows(sources, n, np.inf, 0.0, dev)
        if d0 is not None:
            self.dist = torch.minimum(_warm(d0, (self.k, n), dev),
                                      self.dist)
        self.done = self.k == 0

    def frontier(self) -> torch.Tensor:
        return self.dist

    def advance(self, y: torch.Tensor) -> float:
        nd = torch.minimum(self.dist, y)
        changed = (nd < self.dist).sum(dim=1)
        self.dist = nd
        total = int(changed.sum())                         # the one read
        self.done = total == 0
        return float(total)

    def values(self) -> np.ndarray:
        return to_numpy(self.dist)


class CcStepper:
    """Min-label propagation to the component-wise minimum vertex id;
    one lane, sources ignored.  `l0` warm-starts from prior labels
    (valid upper bounds after insert-only deltas; deletes can split
    components and need a re-seed)."""

    def __init__(self, plan, aux: Dict, sources=(), l0=None, **_):
        n, dev = plan.n_cols, plan.device
        self.plan, self.k = plan, 1
        self.labels = torch.arange(n, dtype=torch.float32, device=dev)[None]
        if l0 is not None:
            self.labels = torch.minimum(_warm(l0, (1, n), dev), self.labels)
        self.done = False

    def frontier(self) -> torch.Tensor:
        return self.labels

    def advance(self, y: torch.Tensor) -> float:
        nl = torch.minimum(self.labels, y)
        changed = int((nl < self.labels).sum())            # the one read
        self.labels = nl
        self.done = changed == 0
        return float(changed)

    def values(self) -> np.ndarray:
        return to_numpy(self.labels)


@dataclasses.dataclass(frozen=True)
class AnalyticDef:
    """One analytic, decomposed for step-wise execution."""

    name: str
    semiring: Semiring
    operand: Callable[[CSR], Tuple[CSR, Dict]]
    stepper: Callable
    source_based: bool          # lanes = sources (vs one state vector)


ANALYTICS: Dict[str, AnalyticDef] = {
    "pagerank": AnalyticDef("pagerank", PLUS_TIMES, pagerank_operand,
                            PageRankStepper, source_based=False),
    "bfs": AnalyticDef("bfs", OR_AND, bfs_operand, BfsStepper,
                       source_based=True),
    "sssp": AnalyticDef("sssp", MIN_PLUS, sssp_operand, SsspStepper,
                        source_based=True),
    "connected_components": AnalyticDef(
        "connected_components", MIN_PLUS, cc_operand, CcStepper,
        source_based=False),
}


def _analytic(analytic: str) -> AnalyticDef:
    d = ANALYTICS.get(analytic)
    if d is None:
        raise ValueError(f"unknown analytic {analytic!r}; "
                         f"have {sorted(ANALYTICS)}")
    return d


def analytic_operand(analytic: str, adj: CSR) -> Tuple[CSR, str, Dict]:
    """(operand matrix, semiring name, aux) for one analytic."""
    d = _analytic(analytic)
    matrix, aux = d.operand(adj)
    return matrix, d.semiring.name, aux


def make_stepper(analytic: str, plan, aux: Dict, sources=(), params=None):
    """Instantiate the per-iteration state machine for one request."""
    return _analytic(analytic).stepper(plan, aux, sources=sources,
                                       **(params or {}))


#: Stepper argument each analytic consumes to resume from prior values.
WARM_START_PARAM = {"pagerank": "r0", "sssp": "d0",
                    "connected_components": "l0"}


def warm_start_params(analytic: str, values, delta=None) -> Optional[Dict]:
    """Stepper params resuming `analytic` from converged `values` after
    edge delta `delta`, or None when correctness needs a re-seed (the
    reference's rules): PageRank always resumes (power iteration reaches
    its unique fixpoint from any start); SSSP and CC resume after
    insert-only deltas (old values are upper bounds the monotone
    iteration drives down) and re-seed after deletes or an unknown
    (None) delta; BFS never resumes (its level-synchronous depths go
    stale under any delta).  `delta` may be the adjacency's or the
    operand's."""
    kw = WARM_START_PARAM.get(analytic)
    if kw is None:
        return None
    if analytic != "pagerank" and (delta is None or delta.has_deletes):
        return None
    return {kw: np.asarray(values, dtype=np.float32)}


def _drive(stepper, plan, max_iters: int, multi: bool) -> GraphResult:
    """Pull `frontier()`, run the plan, feed `advance()`: single-source
    goes through `execute` (the kernels), multi-source through
    `execute_many`."""
    history: List[float] = []
    it = 0
    t0 = time.perf_counter()
    while it < max_iters and not stepper.done:
        it += 1
        F = stepper.frontier()
        y = plan.execute_many(F) if multi else plan.execute(F[0])[None]
        history.append(stepper.advance(y))
    vals = stepper.values()
    return GraphResult(values=vals if multi else vals[0], n_iters=it,
                       converged=bool(stepper.done), history=history,
                       plan=plan, iter_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Blocking drivers (compile one plan, iterate to convergence)
# ---------------------------------------------------------------------------

def pagerank(adj: CSR, damping: float = 0.85, tol: float = 1e-8,
             max_iters: int = 100, *, r0=None, reorder="none",
             format: Optional[str] = None, plan_cache=None,
             use_pallas: bool = True, device=None) -> GraphResult:
    """PageRank by power iteration on P = A^T D_out^{-1} (plus_times);
    dangling mass is redistributed; converges when the L1 step residual
    drops below `tol`.  `r0` overrides the uniform start (normalised)."""
    dev = _plan_device(device)
    matrix, _, aux = analytic_operand("pagerank", adj)
    p = _graph_plan(matrix, PLUS_TIMES, reorder=reorder, format=format,
                    plan_cache=plan_cache, use_pallas=use_pallas,
                    device=dev)
    st = PageRankStepper(p, aux, damping=damping, tol=tol, r0=r0)
    return _drive(st, p, max_iters, multi=False)


def bfs(adj: CSR, source: Union[int, Sequence[int]],
        max_iters: Optional[int] = None, *, reorder="none",
        format: Optional[str] = None, plan_cache=None,
        use_pallas: bool = True, device=None) -> GraphResult:
    """Hop depths from `source` (0 at the source, +inf if unreachable);
    a sequence of sources runs them together through `execute_many`."""
    n = _require_square(adj, "bfs")
    dev = _plan_device(device)
    multi = np.ndim(source) > 0
    matrix, _, aux = analytic_operand("bfs", adj)
    p = _graph_plan(matrix, OR_AND, reorder=reorder, format=format,
                    plan_cache=plan_cache, use_pallas=use_pallas,
                    device=dev)
    st = BfsStepper(p, aux, sources=np.atleast_1d(
        np.asarray(source, dtype=np.int64)))
    return _drive(st, p, n if max_iters is None else max_iters, multi=multi)


def sssp(adj: CSR, source: int, max_iters: Optional[int] = None, *,
         d0=None, reorder="none", format: Optional[str] = None,
         plan_cache=None, use_pallas: bool = True,
         device=None) -> GraphResult:
    """Single-source shortest paths by Bellman-Ford relaxation
    d' = d ⊕ (A^T (min,+) d) to fixpoint; unreachable vertices keep
    +inf.  `d0` warm-starts from prior distances (valid after
    insert-only graph deltas)."""
    n = _require_square(adj, "sssp")
    dev = _plan_device(device)
    matrix, _, aux = analytic_operand("sssp", adj)
    p = _graph_plan(matrix, MIN_PLUS, reorder=reorder, format=format,
                    plan_cache=plan_cache, use_pallas=use_pallas,
                    device=dev)
    st = SsspStepper(p, aux, sources=[source], d0=d0)
    return _drive(st, p, n if max_iters is None else max_iters, multi=False)


def connected_components(adj: CSR, max_iters: Optional[int] = None, *,
                         l0=None, reorder="none",
                         format: Optional[str] = None, plan_cache=None,
                         use_pallas: bool = True,
                         device=None) -> GraphResult:
    """Component labels (the minimum vertex id of each component) by
    min-label propagation over the symmetrized zero-weight pattern.
    `l0` warm-starts from prior labels (valid after insert-only
    deltas)."""
    n = _require_square(adj, "connected_components")
    dev = _plan_device(device)
    matrix, _, aux = analytic_operand("connected_components", adj)
    p = _graph_plan(matrix, MIN_PLUS, reorder=reorder, format=format,
                    plan_cache=plan_cache, use_pallas=use_pallas,
                    device=dev)
    st = CcStepper(p, aux, l0=l0)
    return _drive(st, p, n if max_iters is None else max_iters, multi=False)


DRIVERS = {"pagerank": pagerank, "bfs": bfs, "sssp": sssp,
           "connected_components": connected_components}

__all__ = ["GraphResult", "transpose_csr", "pagerank", "bfs", "sssp",
           "connected_components", "DRIVERS", "AnalyticDef", "ANALYTICS",
           "analytic_operand", "make_stepper", "check_sources",
           "plan_options", "PageRankStepper", "BfsStepper", "SsspStepper",
           "CcStepper", "warm_start_params", "WARM_START_PARAM"]
