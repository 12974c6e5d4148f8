"""Admission control: warm plans schedule now, cold plans queue to compile.

Counterpart of `repro.serve_graph.admission`, host-only and unchanged.

The serving engine's front door separates the two costs the plan cache
exists to separate: a request whose (graph, analytic) plan is already
resident is *warm* and goes straight to the scheduler's ready set, while
a cache miss parks the request behind a bounded FIFO compile queue.
Compiles burn a per-step budget (`run_compiles`) so they never stall
running iterations, and the queue bound applies back-pressure: when it
is full, missing requests simply stay in `waiting` -- but warm requests
behind them still pass (head-of-line blocking applies to *compiles*, not
to admission).

Concurrent misses on the same plan key join one pending entry -- dozens
of requests against a just-uploaded graph trigger exactly one compile,
and all of them release together when it lands.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from .requests import AnalyticRequest


class AdmissionController:
    def __init__(self, plan_cache, compile_queue_cap: int = 8):
        self.cache = plan_cache
        self.compile_queue_cap = compile_queue_cap
        self.waiting: Deque[AnalyticRequest] = deque()
        self.compile_q: Deque[str] = deque()          # unique plan keys, FIFO
        self.pending: Dict[str, List[AnalyticRequest]] = {}
        self.warm_hits = 0       # requests admitted off a resident plan
        self.cold_misses = 0     # requests that had to wait on a compile
        self.backpressure = 0    # request-steps stalled on a full queue

    def submit(self, req: AnalyticRequest) -> None:
        self.waiting.append(req)

    def intake(self, key_of: Callable[[AnalyticRequest], str]
               ) -> List[AnalyticRequest]:
        """One admission pass over `waiting` (FIFO).  Returns the warm
        requests, ready to schedule this step; misses join or enqueue
        their plan key, or stay in `waiting` under back-pressure."""
        ready: List[AnalyticRequest] = []
        still: Deque[AnalyticRequest] = deque()
        while self.waiting:
            req = self.waiting.popleft()
            key = key_of(req)
            if self.cache.contains(key):
                self.warm_hits += 1
                ready.append(req)
            elif key in self.pending:
                self.cold_misses += 1
                self.pending[key].append(req)
            elif len(self.compile_q) < self.compile_queue_cap:
                self.cold_misses += 1
                self.compile_q.append(key)
                self.pending[key] = [req]
            else:
                self.backpressure += 1
                still.append(req)
        self.waiting = still
        return ready

    def park(self, key: str) -> None:
        """Schedule a *background* compile for `key` -- no requester yet.

        The streaming lifecycle parks past-budget re-plans here: the key
        shares the per-step compile budget with request-driven misses
        (FIFO behind whatever is already queued) but bypasses the queue
        cap, because a forced re-plan cannot be dropped -- its old plan
        generation has already been retired from the serving key.  Later
        misses on the same key join the pending entry as usual."""
        if key in self.pending:
            return
        self.compile_q.append(key)
        self.pending[key] = []

    def run_compiles(self, budget: Optional[int],
                     compile_key: Callable[[str], object]
                     ) -> List[AnalyticRequest]:
        """Compile up to `budget` queued keys (FIFO) and release every
        request that was pending on them.  `budget=None` drains the whole
        queue this step -- the right setting when compiles are cheap,
        where rationing them one per step would park requests for no
        reason."""
        released: List[AnalyticRequest] = []
        if budget is None:
            budget = len(self.compile_q)
        while budget > 0 and self.compile_q:
            key = self.compile_q.popleft()
            compile_key(key)
            released.extend(self.pending.pop(key))
            budget -= 1
        return released

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.compile_q and not self.pending

    def stats(self) -> Dict[str, int]:
        return {"waiting": len(self.waiting),
                "compile_queue": len(self.compile_q),
                "warm_hits": self.warm_hits,
                "cold_misses": self.cold_misses,
                "backpressure": self.backpressure}


__all__ = ["AdmissionController"]
