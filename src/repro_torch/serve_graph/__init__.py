"""Graph-analytics serving on the card: continuous batching over the
plan cache (counterpart of `repro.serve_graph`).

  requests    AnalyticRequest / AnalyticResult records, plus the edge
              stream: GraphMutation batches and their MutationResult
  admission   warm-hit vs bounded compile queue with FIFO back-pressure;
              `park` queues forced background re-plans past the cap
  scheduler   lane-pool FIFO admission, youngest-first preemption,
              `migrate` for streaming plan retirement
  engine      the per-step loop: apply mutations -> intake -> compile
              budget -> admit -> coalesced iterate on the plan's device
              -> convergence release; mutations move each derived plan
              through the overlay / background-replan / rebase lifecycle
"""
from .admission import AdmissionController
from .engine import GraphEngine, GraphEngineConfig
from .requests import (AnalyticRequest, AnalyticResult, GraphMutation,
                       MutationResult)
from .scheduler import GraphScheduler, RunningRequest

__all__ = ["AdmissionController", "GraphEngine", "GraphEngineConfig",
           "AnalyticRequest", "AnalyticResult", "GraphMutation",
           "MutationResult", "GraphScheduler", "RunningRequest"]
