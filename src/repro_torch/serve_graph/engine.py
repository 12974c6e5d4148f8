"""The analytics serving engine: continuous batching over the plan cache.

Counterpart of `repro.serve_graph.engine`.  Registered graphs play the
role of model weights, compiled `SpmvPlan`s that of the compiled decode
program, and one engine step advances every running analytic by one
iteration:

  1. pending `GraphMutation`s apply first, moving each derived
     (graph, analytic) plan through the streaming lifecycle -- overlay,
     background re-plan with an atomic swap, or cold rebase -- and
     rebinding (warm-started) or migrating in-flight requests;
  2. admission: requests whose plan is resident in the `PlanCache` go
     ready now; misses queue behind a bounded compile queue;
  3. at most `compiles_per_step` queued plans compile;
  4. the lane scheduler admits ready requests FIFO, preempting
     youngest-first when the lane pool is exhausted;
  5. running requests on the same plan coalesce into one
     `execute_many`, padded to a power-of-two lane count
     (`lane_bucket`), as the reference pads them.

Where the port differs: the config's `device` (None: the card, resolved
when the engine is built, so a missing card raises; "cpu" for the plain
versions) replaces the reference's `interpret`, and plans are keyed
through the drivers' `plan_options`, so with device=None the keys are
the reference's and the blocking drivers'.  The coalesced batch stays
on the plan's device: the steppers' frontiers are concatenated there,
padded with zeros, and each stepper advances on its slice of `y`.  On
an 'ell', 'hyb' or 'csr-seg' card plan `execute_many` is one launch of
each batched kernel, so a padded lane costs its column of the SpMM (its
gathers and its row of Y), not a launch; on the other card plans it
runs `execute` once per row, and a padded lane costs a launch like a
real one.  `stats()` counts both (`lanes`, `padded_lanes`).  Each mutation's host seconds (the adjacency delta,
the operands, `csr_diff`, `merge`, overlay installation, re-keying)
are kept in `mutation_seconds`.

The engine is host-side deterministic: identical request traces give
identical schedules, preemption logs and mutation actions -- the
reference's -- and bit-identical results.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.delta import EdgeDelta, csr_diff
from repro_torch.device import resolve_device
from repro_torch.graph.drivers import (ANALYTICS, analytic_operand,
                                       check_sources, make_stepper,
                                       plan_options, warm_start_params)
from repro_torch.plan import PlanCache, compile as compile_plan
from repro_torch.plan.cache import compile_kwargs
from repro_torch.plan.overlay import OverlaidPlan, overlay, overlay_eligible

from .admission import AdmissionController
from .requests import (AnalyticRequest, AnalyticResult, GraphMutation,
                       MutationResult)
from .scheduler import GraphScheduler, RunningRequest


@dataclasses.dataclass
class GraphEngineConfig:
    n_lanes: int = 64               # batch-lane pool (= max coalesced width)
    compile_queue_cap: int = 8      # bounded miss queue (back-pressure past it)
    compiles_per_step: Optional[int] = 1   # compile budget per step; None
                                    # drains the queue every step
    max_plans: int = 64             # plan-cache LRU capacity
    reorder: str = "none"           # compile option for every served plan
    predictor: str = "none"         # candidate scoring of served plans
                                    # ('none' keeps the blocking drivers'
                                    # cache keys; 'model' scores
                                    # reorder='auto' fleets by the
                                    # shipped cost model)
    use_pallas: bool = True         # False: the containers' plain oracles
    device: object = None           # None: the card; "cpu": plain versions
    max_iters_default: int = 256    # per-request iteration cap
    lane_bucket: bool = True        # pad batches to pow2 lane counts
    staleness_budget: float = 0.05  # delta_nnz/base_nnz past which a
                                    # mutation forces a background re-plan
                                    # + atomic swap instead of an overlay


@dataclasses.dataclass
class _Derived:
    """Per-(graph, analytic) plan lineage: `matrix` is the current
    operand, `base_matrix` the operand the resident base plan froze,
    `delta` the accumulated operand delta between them (None once
    rebased), `key` the serving cache key (content key, or chained key
    for an overlaid generation)."""

    matrix: object
    opts: Dict
    aux: Dict
    key: str
    base_matrix: object
    delta: Optional[EdgeDelta] = None


class GraphEngine:
    def __init__(self, cfg: Optional[GraphEngineConfig] = None,
                 plan_cache: Optional[PlanCache] = None):
        self.cfg = cfg or GraphEngineConfig()
        self.device = resolve_device(self.cfg.device)
        self.plan_cache = (plan_cache if plan_cache is not None
                           else PlanCache(max_plans=self.cfg.max_plans))
        self.admission = AdmissionController(
            self.plan_cache, compile_queue_cap=self.cfg.compile_queue_cap)
        self.scheduler = GraphScheduler(self.cfg.n_lanes)
        self.graphs: Dict[str, object] = {}
        self._derived: Dict[Tuple[str, str], _Derived] = {}
        self._by_key: Dict[str, Tuple[object, Dict]] = {}
        self.results: Dict[int, AnalyticResult] = {}
        self.mutation_results: Dict[int, MutationResult] = {}
        self.mutation_seconds: Dict[int, Dict[str, float]] = {}
        self._mutations: Deque[GraphMutation] = deque()
        self._swap_on_land: Dict[str, str] = {}   # new key -> key to retire
        self._warm_state: Dict[int, Dict] = {}    # req_id -> stepper params
        self.step_count = 0
        self.submitted = 0
        self.mutations_applied = 0
        self.spmm_calls = 0
        self.lanes = 0
        self.padded_lanes = 0
        self.max_running = 0
        self.max_inflight = 0

    # -- registration / intake ----------------------------------------------

    def register_graph(self, graph_id: str, adj) -> None:
        """Register an adjacency under a serving id; operands and plans
        stay lazy until a request arrives for the graph."""
        if adj.n_rows != adj.n_cols:
            raise ValueError(f"graph {graph_id!r} must be square, "
                             f"got {adj.n_rows}x{adj.n_cols}")
        self.graphs[graph_id] = adj

    def submit(self, req) -> None:
        """Validate and enqueue.  Rejections are immediate (unknown
        graph/analytic, out-of-range sources, wider than the lane pool).
        `GraphMutation`s queue separately and apply at the top of the
        next step, in submit order."""
        if isinstance(req, GraphMutation):
            if req.graph_id not in self.graphs:
                raise KeyError(f"graph {req.graph_id!r} is not registered; "
                               f"have {sorted(self.graphs)}")
            req.arrived_step = self.step_count
            self._mutations.append(req)
            return
        adj = self.graphs.get(req.graph_id)
        if adj is None:
            raise KeyError(f"graph {req.graph_id!r} is not registered; "
                           f"have {sorted(self.graphs)}")
        if req.analytic not in ANALYTICS:
            raise ValueError(f"unknown analytic {req.analytic!r}; "
                             f"have {sorted(ANALYTICS)}")
        if req.sources and req.analytic == "connected_components":
            raise ValueError("connected_components takes no sources")
        check_sources(np.asarray(req.sources, dtype=np.int64), adj.n_rows,
                      req.analytic)
        if req.lanes > self.cfg.n_lanes:
            raise ValueError(f"request {req.req_id} needs {req.lanes} lanes "
                             f"but the pool has {self.cfg.n_lanes}")
        req.arrived_step = self.step_count
        self.submitted += 1
        self.admission.submit(req)

    # -- plan resolution -----------------------------------------------------

    def _derive(self, graph_id: str, analytic: str) -> _Derived:
        """The lineage record of one (graph, analytic), derived once and
        kept current by `_apply_mutation`; keyed with the drivers' own
        `plan_options`, so engine and driver plans share cache entries."""
        ck = (graph_id, analytic)
        hit = self._derived.get(ck)
        if hit is not None:
            return hit
        matrix, semiring, aux = analytic_operand(analytic,
                                                 self.graphs[graph_id])
        opts = plan_options(semiring, reorder=self.cfg.reorder,
                            predictor=self.cfg.predictor,
                            use_pallas=self.cfg.use_pallas,
                            device=self.cfg.device)
        key = self.plan_cache.key_for(matrix, **opts)
        st = _Derived(matrix=matrix, opts=opts, aux=aux, key=key,
                      base_matrix=matrix)
        self._derived[ck] = st
        self._by_key[key] = (matrix, opts)
        return st

    def _key_of(self, req: AnalyticRequest) -> str:
        return self._derive(req.graph_id, req.analytic).key

    def _compile_key(self, key: str):
        """Compile (or fetch) the plan stored under `key` (keys are looked
        up, never re-derived: a chained key has no content equivalent).
        A key the mutation lifecycle flagged lands as a `PlanCache.swap`
        that retires the superseded generation atomically."""
        matrix, opts = self._by_key[key]
        kw = compile_kwargs(opts)
        supersedes = self._swap_on_land.pop(key, None)
        if supersedes is not None:
            return self.plan_cache.swap(
                key, lambda: compile_plan(matrix, **kw),
                supersedes=supersedes)
        return self.plan_cache.get_or_build(
            key, lambda: compile_plan(matrix, **kw))

    def _start(self, req: AnalyticRequest) -> RunningRequest:
        st = self._derive(req.graph_id, req.analytic)
        plan = self._compile_key(st.key)          # warm: a hit
        params = dict(req.params)
        warm = self._warm_state.pop(req.req_id, None)
        if warm is not None:
            params.update(warm)                   # resume migrated state
        stepper = make_stepper(req.analytic, plan, st.aux,
                               sources=np.asarray(req.sources, np.int64),
                               params=params)
        cap = (req.max_iters if req.max_iters is not None
               else self.cfg.max_iters_default)
        return RunningRequest(req=req, stepper=stepper, plan=plan,
                              plan_key=st.key, max_iters=cap)

    # -- the streaming mutation lifecycle -------------------------------------

    def _apply_mutation(self, mut: GraphMutation) -> None:
        """Apply one edge batch: mutate the adjacency, then move every
        derived lineage of the graph through the plan state machine and
        rebind its in-flight requests."""
        secs = dict.fromkeys(("delta_s", "operand_s", "diff_s", "merge_s",
                              "overlay_s", "key_s"), 0.0)
        t0 = time.perf_counter()
        adj = self.graphs[mut.graph_id]
        adj_delta = EdgeDelta.from_updates(adj, inserts=mut.inserts,
                                           deletes=mut.deletes)
        self.graphs[mut.graph_id] = adj.apply_delta(adj_delta)
        secs["delta_s"] = time.perf_counter() - t0
        actions: Dict[str, str] = {}
        for (gid, analytic), st in list(self._derived.items()):
            if gid != mut.graph_id:
                continue
            actions[analytic] = self._shift_lineage(gid, analytic, st, secs)
        secs["host_s"] = time.perf_counter() - t0
        self.mutations_applied += 1
        self.mutation_seconds[mut.req_id] = secs
        self.mutation_results[mut.req_id] = MutationResult(
            req_id=mut.req_id, graph_id=mut.graph_id,
            applied_step=self.step_count, delta_nnz=adj_delta.nnz,
            actions=actions)

    def _shift_lineage(self, gid: str, analytic: str, st: _Derived,
                       secs: Dict[str, float]) -> str:
        """Move one lineage onto the mutated graph; returns the action
        ('overlay', 'replan', 'rebase' or 'noop').  The serving key flips
        here, synchronously, so no request is admitted against the
        retired generation."""
        t0 = time.perf_counter()
        new_matrix, _, new_aux = analytic_operand(analytic,
                                                  self.graphs[gid])
        t1 = time.perf_counter()
        op_delta = csr_diff(st.matrix, new_matrix)
        t2 = time.perf_counter()
        secs["operand_s"] += t1 - t0
        secs["diff_s"] += t2 - t1
        old_key = st.key
        if op_delta.nnz == 0:
            st.matrix, st.aux = new_matrix, new_aux
            self._by_key[old_key] = (new_matrix, st.opts)
            return "noop"
        total = st.delta.merge(op_delta) if st.delta is not None else op_delta
        secs["merge_s"] += time.perf_counter() - t2
        semiring = st.opts["semiring"]
        within = (overlay_eligible(total, semiring)
                  and total.nnz / max(st.base_matrix.nnz, 1)
                  <= self.cfg.staleness_budget)
        resident = self.plan_cache.peek(old_key) if within else None
        t0 = time.perf_counter()
        if resident is not None:
            if isinstance(resident, OverlaidPlan):
                over = overlay(resident, op_delta)
            else:
                over = overlay(resident, total, base_matrix=st.base_matrix,
                               staleness_budget=self.cfg.staleness_budget)
            new_key = self.plan_cache.chained_key(old_key, over.fingerprint)
            self.plan_cache.install_overlay(new_key, over,
                                            supersedes=old_key)
            st.delta = total
            action = "overlay"
            secs["overlay_s"] += time.perf_counter() - t0
        elif within:
            # nothing resident to overlay: re-root the lineage at the
            # materialised operand; the next request compiles it cold
            st.base_matrix, st.delta = new_matrix, None
            new_key = self.plan_cache.key_for(new_matrix, **st.opts)
            action = "rebase"
            secs["key_s"] += time.perf_counter() - t0
        else:
            # past budget or overlay-ineligible delete: retire the
            # serving key now, park one background re-plan of the
            # materialised operand, swap atomically when it lands
            st.base_matrix, st.delta = new_matrix, None
            new_key = self.plan_cache.key_for(new_matrix, **st.opts)
            self.plan_cache.note_delta_recompile()
            if new_key != old_key:
                self._swap_on_land[new_key] = old_key
            self.admission.park(new_key)
            action = "replan"
            secs["key_s"] += time.perf_counter() - t0
        st.matrix, st.aux, st.key = new_matrix, new_aux, new_key
        self._by_key[new_key] = (new_matrix, st.opts)
        self._rebind_running((gid, analytic), new_key, op_delta, st, action)
        return action

    def _rebind_running(self, ck: Tuple[str, str], new_key: str,
                        op_delta: EdgeDelta, st: _Derived,
                        action: str) -> None:
        """Overlay: rebind in-flight requests in place (a fresh stepper on
        the overlaid plan, warm-started where `warm_start_params`
        allows).  Re-plan / rebase: migrate them back through admission
        with their warm state and their arrival seniority."""
        migrated: List[AnalyticRequest] = []
        for run in list(self.scheduler.running):
            if (run.req.graph_id, run.req.analytic) != ck:
                continue
            warm = warm_start_params(run.req.analytic, run.stepper.values(),
                                     op_delta)
            if action == "overlay":
                plan = self.plan_cache.peek(new_key)
                params = dict(run.req.params)
                if warm is not None:
                    params.update(warm)
                run.plan, run.plan_key = plan, new_key
                run.stepper = make_stepper(
                    run.req.analytic, plan, st.aux,
                    sources=np.asarray(run.req.sources, np.int64),
                    params=params)
            else:
                self.scheduler.migrate(run, self.step_count)
                if warm is not None:
                    self._warm_state[run.req.req_id] = warm
                migrated.append(run.req)
        for req in reversed(migrated):
            self.admission.waiting.appendleft(req)

    # -- the engine step ------------------------------------------------------

    def step(self) -> None:
        self.step_count += 1
        while self._mutations:
            self._apply_mutation(self._mutations.popleft())
        for req in self.admission.intake(self._key_of):
            self.scheduler.push_ready(req)
        for req in self.admission.run_compiles(self.cfg.compiles_per_step,
                                               self._compile_key):
            self.scheduler.push_ready(req)
        self.scheduler.admit(self.step_count, self._start)
        self.max_running = max(self.max_running, len(self.scheduler.running))
        self.max_inflight = max(
            self.max_inflight, self.submitted - len(self.results))
        self._iterate_running()

    def _iterate_running(self) -> None:
        """One coalesced SpMV iteration per distinct plan, on the plan's
        device, then release every request that converged (or hit its
        iteration cap)."""
        groups: "OrderedDict[str, List[RunningRequest]]" = OrderedDict()
        for run in self.scheduler.running:
            if not run.stepper.done:
                groups.setdefault(run.plan_key, []).append(run)
        for key, members in groups.items():
            fronts = [m.stepper.frontier() for m in members]
            F = torch.cat(fronts, dim=0)
            k = F.shape[0]
            kpad = 1 << max(k - 1, 0).bit_length() if self.cfg.lane_bucket \
                else k
            if kpad > k:
                F = torch.cat([F, F.new_zeros((kpad - k, F.shape[1]))])
            y = members[0].plan.execute_many(F)[:k]
            self.spmm_calls += 1
            self.lanes += k
            self.padded_lanes += kpad - k
            off = 0
            for m, f in zip(members, fronts):
                w = f.shape[0]
                m.stepper.advance(y[off:off + w])
                m.iters += 1
                off += w
        for run in list(self.scheduler.running):
            if run.stepper.done or run.iters >= run.max_iters:
                self._finish(run)

    def _finish(self, run: RunningRequest) -> None:
        self.scheduler.finish(run, self.step_count)
        req = run.req
        self.results[req.req_id] = AnalyticResult(
            req_id=req.req_id, graph_id=req.graph_id, analytic=req.analytic,
            values=np.asarray(run.stepper.values()), n_iters=run.iters,
            converged=bool(run.stepper.done),
            arrived_step=req.arrived_step, admitted_step=req.admitted_step,
            finished_step=req.finished_step, restarts=req.restarts)

    # -- driving --------------------------------------------------------------

    @property
    def idle(self) -> bool:
        return (not self._mutations and self.admission.idle
                and self.scheduler.idle)

    def run(self, max_steps: int = 100_000) -> Dict[int, AnalyticResult]:
        """Step until every submitted request has a result (a stuck engine
        raises after `max_steps`)."""
        for _ in range(max_steps):
            if self.idle:
                return self.results
            self.step()
        if not self.idle:
            raise RuntimeError(
                f"engine not idle after {max_steps} steps: "
                f"{self.admission.stats()} {self.scheduler.stats()}")
        return self.results

    def stats(self) -> Dict:
        adm = self.admission.stats()
        served = adm["warm_hits"] + adm["cold_misses"]
        return {
            "steps": self.step_count,
            "submitted": self.submitted,
            "finished": len(self.results),
            "mutations_applied": self.mutations_applied,
            "preemptions": self.scheduler.preemptions,
            "warm_hits": adm["warm_hits"],
            "cold_misses": adm["cold_misses"],
            "backpressure": adm["backpressure"],
            "admission_hit_rate": adm["warm_hits"] / served if served else 0.0,
            "max_running": self.max_running,
            "max_inflight": self.max_inflight,
            "spmm_calls": self.spmm_calls,
            "lanes": self.lanes,
            "padded_lanes": self.padded_lanes,
            "plan_cache": self.plan_cache.stats(),
        }


__all__ = ["GraphEngine", "GraphEngineConfig"]
