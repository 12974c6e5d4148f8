"""`OverlaidPlan` -- a frozen plan plus a small edge delta, served warm.

Counterpart of `repro.plan.overlay`.  Instead of recompiling on every
mutation, keep serving the frozen base plan and correct its output with
a COO pass over the delta:

    y = base.execute(x)            # the planned SpMV, untouched
    y = y (⊕) delta-pass(x)        # O(delta nnz) correction

which is exact (`repro_torch.core.delta` has the algebra): under
plus_times inserts and deletes overlay (deletes as negated values),
under the ⊕-only semirings inserts overlay and deletes force a re-plan
(`overlay_eligible`).

The delta pass runs on the base plan's device, in plain PyTorch (the
reference's pass is plain JAX, not a Pallas kernel).  Its tensors are
built once per overlay generation, on first use.  It reduces with
`Semiring.segment`.  Under plus_times that is `graph.semiring.ordered_sum`
-- a fixed order that depends on the delta's rows only, with its run
table kept per rows tensor -- never CUDA's atomic `index_add_` /
`scatter_add_` / `scatter_reduce` sums, so replays are bit-identical on
the card.  Under the ⊕-only semirings it leaves the ⊕-identity on rows
the delta does not touch (the reference restores it with a count pass).
`execute_many` runs the same pass over a (k, n) batch; each row equals
`execute`.

Lifecycle (what `serve_graph` drives): a plan gathers deltas as
overlays until `delta.nnz / base_matrix.nnz` passes `staleness_budget`
or an ineligible delete arrives; then the materialised matrix is
re-planned and swapped in atomically (`PlanCache.swap`).  Cache keys
chain fingerprints (`fingerprint.chain_fingerprint`), so no generation
re-hashes the base matrix.  The reference's `interpret=` argument is
dropped, as in `SpmvPlan`.  `address_trace` prices the delta pass on
the simulated CPU as a column-sorted COO stream after the base plan's
trace (`telemetry.hierarchy.overlay_address_trace`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.delta import EdgeDelta
from repro_torch.device import to_tensor
from repro_torch.graph.semiring import resolve

from .fingerprint import chain_fingerprint, delta_fingerprint

#: Default re-plan threshold: delta nnz over base nnz (the reference's).
DEFAULT_STALENESS_BUDGET = 0.05


def overlay_eligible(delta: EdgeDelta, semiring: str) -> bool:
    """True when `delta` can be served as an overlay under `semiring`:
    always for plus_times, insert-only otherwise."""
    return semiring == "plus_times" or not delta.has_deletes


@dataclasses.dataclass
class OverlaidPlan:
    """A base `SpmvPlan` plus an accumulated `EdgeDelta`, plan-shaped.

    `base_matrix` is the original-order CSR the base plan froze (the
    matrix `delta` is expressed against); `fingerprint` is the chained
    digest of this generation.  Build via `overlay(...)`.
    """

    base: Any                        # the frozen SpmvPlan
    base_matrix: Any                 # original-order CSR the delta targets
    delta: EdgeDelta
    fingerprint: str
    staleness_budget: float = DEFAULT_STALENESS_BUDGET
    _pass: Any = dataclasses.field(default=None, repr=False)
    _materialized: Any = dataclasses.field(default=None, repr=False)
    _traces: Dict = dataclasses.field(default_factory=dict, repr=False)

    # -- geometry / plan-shape delegation -----------------------------------

    @property
    def n_rows(self) -> int:
        return self.base.n_rows

    @property
    def n_cols(self) -> int:
        return self.base.n_cols

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def csr(self):
        return self.base.csr

    @property
    def container(self):
        return self.base.container

    @property
    def format_name(self) -> str:
        return self.base.format_name

    @property
    def semiring(self) -> str:
        return self.base.semiring

    @property
    def threads(self) -> int:
        return self.base.threads

    @property
    def reordering(self):
        return self.base.reordering

    @property
    def report(self):
        return self.base.report

    @property
    def compile_stats(self) -> Dict:
        return self.base.compile_stats

    # -- lifecycle state ----------------------------------------------------

    @property
    def staleness(self) -> float:
        """Delta size relative to the base: what the budget caps."""
        return self.delta.nnz / max(self.base_matrix.nnz, 1)

    @property
    def eligible(self) -> bool:
        return overlay_eligible(self.delta, self.semiring)

    @property
    def stale(self) -> bool:
        """Budget exceeded, or a delete under a non-invertible semiring."""
        return self.staleness > self.staleness_budget or not self.eligible

    def materialize(self):
        """base_matrix + delta as a fresh canonical CSR (kept): what a
        past-budget re-plan compiles."""
        if self._materialized is None:
            self._materialized = self.base_matrix.apply_delta(self.delta)
        return self._materialized

    # -- execution ----------------------------------------------------------

    def _delta_tensors(self):
        """(rows, cols, vals) of the delta pass on the base's device,
        built once."""
        if self._pass is None:
            if self.semiring == "plus_times":
                coo = self.delta.signed_coo()
            elif not self.eligible:
                raise ValueError(
                    f"delta carries deletes under semiring "
                    f"{self.semiring!r}: overlay-ineligible, "
                    "materialize and re-plan instead")
            else:
                coo = self.delta.insert_coo()
            self._pass = tuple(to_tensor(a, self.device) for a in coo)
        return self._pass

    def delta_pass(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The O(delta) correction: y (⊕) (delta ⊗ x) over the last axis
        of `y` (n,) / (k, n), tensors on the base's device."""
        rows, cols, vals = self._delta_tensors()
        sr = resolve(self.semiring)
        terms = sr.mul(vals, x.index_select(-1, cols))
        return sr.add(y, sr.segment(terms, rows, self.n_rows))

    def execute(self, x) -> torch.Tensor:
        """y = (base + delta) @ x: the planned SpMV, then the delta pass."""
        y = self.base.execute(x)
        if self.delta.nnz == 0:
            return y
        return self.delta_pass(y, self.base._input(x))

    __call__ = execute

    def execute_many(self, X) -> torch.Tensor:
        """Batched (k, n): the base's `execute_many`, then the delta pass
        over all k rows at once (each row as `execute` gives it)."""
        Y = self.base.execute_many(X)
        if self.delta.nnz == 0:
            return Y
        return self.delta_pass(Y, self.base._input(X))

    def address_trace(self, machine):
        """The base plan's trace, then the delta pass priced as a
        column-sorted COO stream (ascending x gathers), in the base
        plan's permuted coordinates; cached per machine."""
        if machine not in self._traces:
            from repro_torch.telemetry.hierarchy import overlay_address_trace

            rows, cols = self.delta.rows, self.delta.cols
            if self.base.reordering is not None:
                irp = np.asarray(self.base.reordering.inv_row_perm)
                icp = np.asarray(self.base.reordering.inv_col_perm)
                rows, cols = irp[rows], icp[cols]
            self._traces[machine] = overlay_address_trace(
                self.base.csr, self.base.format_name, rows, cols, machine,
                container=self.base.container)
        return self._traces[machine]

    def summary(self) -> str:
        return (f"OverlaidPlan[{self.fingerprint[:8]}] "
                f"+{self.delta.n_inserts} -{self.delta.n_deletes} "
                f"staleness={self.staleness:.3f}/{self.staleness_budget:g} "
                f"over {self.base.summary()}")


def overlay(plan_or_overlaid, delta: EdgeDelta, *, base_matrix=None,
            staleness_budget: Optional[float] = None) -> OverlaidPlan:
    """Extend a plan (or an existing overlay) with one more delta batch.

    Wrapping a fresh `SpmvPlan` starts a lineage: `base_matrix` defaults
    to the plan's kept CSR, un-permuted back to the original order when
    the plan reordered.  Wrapping an `OverlaidPlan` merges the new batch
    into the accumulated delta and chains the fingerprint -- only the
    new batch is hashed.
    """
    if isinstance(plan_or_overlaid, OverlaidPlan):
        prev = plan_or_overlaid
        return OverlaidPlan(
            base=prev.base, base_matrix=prev.base_matrix,
            delta=prev.delta.merge(delta),
            fingerprint=chain_fingerprint(prev.fingerprint,
                                          delta_fingerprint(delta)),
            staleness_budget=(prev.staleness_budget if staleness_budget is None
                              else float(staleness_budget)))
    plan = plan_or_overlaid
    if base_matrix is None:
        if plan.csr is None:
            raise ValueError(
                "plan was compiled with keep_csr=False; pass base_matrix= "
                "explicitly to overlay it")
        base_matrix = plan.csr
        if plan.reordering is not None:
            base_matrix = base_matrix.permute(plan.reordering.inv_row_perm,
                                              plan.reordering.inv_col_perm)
    if (delta.n_rows, delta.n_cols) != (base_matrix.n_rows,
                                        base_matrix.n_cols):
        raise ValueError(f"delta shape {delta.shape} does not match the "
                         f"base matrix {base_matrix.shape}")
    return OverlaidPlan(
        base=plan, base_matrix=base_matrix, delta=delta,
        fingerprint=chain_fingerprint(plan.fingerprint,
                                      delta_fingerprint(delta)),
        staleness_budget=(DEFAULT_STALENESS_BUDGET if staleness_budget is None
                          else float(staleness_budget)))


__all__ = ["OverlaidPlan", "overlay", "overlay_eligible",
           "DEFAULT_STALENESS_BUDGET"]
