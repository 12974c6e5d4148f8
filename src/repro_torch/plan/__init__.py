"""repro_torch.plan -- compile-once SpMV plans on the card.

    from repro_torch import plan
    p = plan.compile(csr)            # analyze -> format -> layout (card)
    p = plan.compile(csr, reorder="rcm")   # reorder first; x, y unchanged
    y = p.execute(x)                 # one hand-written kernel per SpMV
    Y = p.execute_many(X)            # one batched SpMM (ell, hyb,
                                     # csr-seg), rows equal to execute
    ov = plan.overlay(p, delta)      # p + an EdgeDelta, served warm
    y = ov.execute(x)                # base SpMV, then the O(delta) pass
    plan.save_plan(p, ckpt_dir)      # and `load_plan(ckpt_dir)` after a
                                     # restart, in either package
"""
from .cache import DEFAULT_CACHE, PlanCache, compile_kwargs, get_plan
from .costmodel import harvest
from .compiler import (SEMIRING_FORMATS, choose_format, compile, convert,
                       plan_for_container)
from .fingerprint import (chain_fingerprint, delta_fingerprint,
                          fingerprint_arrays, forget_fingerprint,
                          matrix_fingerprint)
from .overlay import (DEFAULT_STALENESS_BUDGET, OverlaidPlan, overlay,
                      overlay_eligible)
from .plan import SpmvPlan
from .serial import load_plan, plan_from_state, plan_state, save_plan

__all__ = ["SpmvPlan", "compile", "choose_format", "convert",
           "plan_for_container", "SEMIRING_FORMATS", "PlanCache",
           "DEFAULT_CACHE", "get_plan", "compile_kwargs",
           "matrix_fingerprint", "fingerprint_arrays", "delta_fingerprint",
           "chain_fingerprint", "forget_fingerprint", "OverlaidPlan",
           "overlay", "overlay_eligible", "DEFAULT_STALENESS_BUDGET",
           "save_plan", "load_plan", "plan_state", "plan_from_state",
           "harvest"]
