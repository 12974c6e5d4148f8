"""Semiring graph analytics on the port's compile-once SpMV plans
(counterparts of `repro.graph.semiring` and `repro.graph.drivers`)."""
from .drivers import (ANALYTICS, DRIVERS, AnalyticDef, GraphResult,
                      analytic_operand, bfs, check_sources,
                      connected_components, make_stepper, pagerank,
                      plan_options, sssp, transpose_csr,
                      warm_start_params)
from .semiring import (MAX_TIMES, MIN_PLUS, OR_AND, PLUS_TIMES, SEMIRINGS,
                       Semiring, resolve)

__all__ = ["Semiring", "SEMIRINGS", "PLUS_TIMES", "MIN_PLUS", "OR_AND",
           "MAX_TIMES", "resolve", "GraphResult", "DRIVERS", "pagerank",
           "bfs", "sssp", "connected_components", "transpose_csr",
           "AnalyticDef", "ANALYTICS", "analytic_operand", "make_stepper",
           "check_sources", "plan_options", "warm_start_params"]
