"""Lane-pool scheduler: FIFO admission, youngest-first preemption.

Counterpart of `repro.serve_graph.scheduler`, host-only and unchanged.
The policy is the token-serving scheduler's, re-based from KV blocks
onto batch lanes (one lane = one state vector riding a coalesced
`execute_many`):

  * the ready set is ordered by (arrived_step, req_id) -- global
    seniority, so a preempted request re-enters at its arrival position
    rather than jumping the line or losing its place;
  * admission is strict FIFO: while the *oldest* ready request fits the
    free lanes, admit it; when it does not fit, preempt the youngest
    running request that is strictly younger than it, and only give up
    (no skip-ahead) when no such victim exists;
  * preemption restarts the victim from scratch (its stepper state is
    discarded, as a preempted token request is re-prefilled), and finished
    requests release their lanes individually the step they converge.

Everything is host-side and deterministic: identical request traces
produce identical `log` sequences of (step, event, req_id), which the
determinism tests pin -- the same sequences as the reference's.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Tuple

from .requests import AnalyticRequest


@dataclasses.dataclass
class RunningRequest:
    """One admitted request: its per-iteration state machine plus the
    plan it multiplies through (plan_key groups co-batched work)."""
    req: AnalyticRequest
    stepper: object
    plan: object
    plan_key: str
    iters: int = 0
    max_iters: int = 0

    def seniority(self) -> Tuple[int, int]:
        return (self.req.arrived_step, self.req.req_id)


class GraphScheduler:
    def __init__(self, n_lanes: int):
        self.n_lanes = n_lanes
        self.ready: List[Tuple[int, int, AnalyticRequest]] = []
        self.running: List[RunningRequest] = []      # admission order
        self.finished: List[AnalyticRequest] = []
        self.preemptions = 0
        self.log: List[Tuple[int, str, int]] = []

    @property
    def lanes_used(self) -> int:
        return sum(r.req.lanes for r in self.running)

    @property
    def lanes_free(self) -> int:
        return self.n_lanes - self.lanes_used

    def push_ready(self, req: AnalyticRequest) -> None:
        bisect.insort(self.ready, (req.arrived_step, req.req_id, req))

    def admit(self, step: int, start: Callable[[AnalyticRequest],
                                               RunningRequest]
              ) -> List[RunningRequest]:
        """Admit ready requests in seniority order while lanes allow;
        `start` materializes the stepper (fresh state -- also the restart
        path after preemption).  Returns the newly admitted runs."""
        admitted: List[RunningRequest] = []
        while self.ready:
            arrived, rid, req = self.ready[0]
            if req.lanes <= self.lanes_free:
                self.ready.pop(0)
                req.admitted_step = step
                run = start(req)
                self.running.append(run)
                admitted.append(run)
                self.log.append((step, "admit", req.req_id))
                continue
            victim = self._youngest_younger_than((arrived, rid))
            if victim is None:
                break        # FIFO: do not skip ahead of the head request
            self._preempt(victim, step)
        return admitted

    def _youngest_younger_than(self, head_key: Tuple[int, int]):
        candidates = [r for r in self.running if r.seniority() > head_key]
        if not candidates:
            return None
        return max(candidates, key=RunningRequest.seniority)

    def _preempt(self, run: RunningRequest, step: int) -> None:
        self.running.remove(run)
        run.req.restarts += 1
        self.push_ready(run.req)     # re-enters at its arrival seniority
        self.preemptions += 1
        self.log.append((step, "preempt", run.req.req_id))

    def migrate(self, run: RunningRequest, step: int) -> None:
        """Pull a running request off the lane pool because its plan
        went cold (streaming re-plan): unlike preemption the caller
        re-routes the request through admission itself -- usually
        carrying warm stepper state over -- so nothing is pushed to
        `ready` here and no restart is counted."""
        self.running.remove(run)
        self.log.append((step, "migrate", run.req.req_id))

    def finish(self, run: RunningRequest, step: int) -> None:
        self.running.remove(run)
        run.req.finished_step = step
        self.finished.append(run.req)
        self.log.append((step, "finish", run.req.req_id))

    @property
    def idle(self) -> bool:
        return not self.ready and not self.running

    def stats(self) -> Dict[str, float]:
        return {"ready": len(self.ready), "running": len(self.running),
                "finished": len(self.finished),
                "lane_utilization": self.lanes_used / max(self.n_lanes, 1),
                "preemptions": self.preemptions}


__all__ = ["GraphScheduler", "RunningRequest"]
