"""repro_torch.plan -- compile-once SpMV plans on the card.

    from repro_torch import plan
    p = plan.compile(csr)            # analyze -> format -> layout (card)
    p = plan.compile(csr, reorder="rcm")   # reorder first; x, y unchanged
    y = p.execute(x)                 # one hand-written kernel per SpMV
    Y = p.execute_many(X)            # one execute per row of X
"""
from .cache import DEFAULT_CACHE, PlanCache, get_plan
from .compiler import (SEMIRING_FORMATS, choose_format, compile, convert,
                       plan_for_container)
from .fingerprint import fingerprint_arrays, matrix_fingerprint
from .plan import SpmvPlan

__all__ = ["SpmvPlan", "compile", "choose_format", "convert",
           "plan_for_container", "SEMIRING_FORMATS", "PlanCache",
           "DEFAULT_CACHE", "get_plan", "matrix_fingerprint",
           "fingerprint_arrays"]
