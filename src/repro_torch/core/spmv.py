"""Structure-aware per-call SpMV: a thin client over `repro_torch.plan`.

Counterpart of `repro.core.spmv`:

  * `auto_format(csr, ...)` reads the structure report and converts the
    matrix to the format `plan.choose_format` picks (DIA for bands, BELL
    for dense 8x128 tiles, HYB / segmented CSR for power-law rows, CSR
    otherwise), after an optional reordering;
  * `spmv(matrix, x, ...)` multiplies any container.  With
    `use_pallas=True` (the default) a CUDA container goes through the
    plan `plan.DEFAULT_CACHE` keeps for it (compiled once by
    `plan.plan_for_container`), so repeated calls on one matrix prepare
    its layout once and launch the format's kernel each time; a CPU
    container runs the kernels' plain versions the same way.
    `use_pallas=False` runs the container's plain PyTorch oracle (the
    reference's `spmv_*_jnp`).  The option keeps the reference's name.
    A dense 2-D tensor is multiplied with `@`;
  * `power_iteration(matrix, x0)` repeats `spmv` with normalisation;
  * `pagerank(csr)` runs the graph driver on the transpose for a fixed
    iteration count.

The reference's default is `use_pallas=False`, because its kernels are
TPU Pallas; the port's is True: on the card the hand-written kernels run
unless the caller asks for the plain versions.  The reference's
jit-tracer branch has no counterpart (PyTorch runs eagerly).
"""
from __future__ import annotations

import numpy as np
import torch

from . import structure
from .formats import BELL, CSR, DIA, ELL, HYB


def auto_format(csr: CSR, report: structure.StructureReport | None = None,
                reordering=None, threads: int = 1):
    """The container `plan.choose_format` picks for this matrix's
    structure, on the CSR's device.  With `reordering`, the permutation
    is applied first and the structure re-analysed, so an RCM'd
    scrambled band becomes DIA again; pass the same reordering to `spmv`
    to multiply in the original order.  `threads` biases dispersed
    unstructured matrices toward the segmented layout, as plan
    compilation does."""
    from repro_torch import plan as _plan

    if reordering is not None:
        csr = reordering.apply(csr)
        report = None
    rep = report or structure.analyze(csr)
    return _plan.convert(csr, _plan.choose_format(rep, threads=threads))


def spmv(matrix, x: torch.Tensor, use_pallas: bool = True,
         reordering=None) -> torch.Tensor:
    """y = A @ x for any supported container (plus-times).

    `reordering` declares `matrix` the REORDERED operand (from
    `reordering.apply` or `auto_format(..., reordering=...)`) while x and
    y stay in the ORIGINAL order."""
    if reordering is not None:
        y = spmv(matrix, reordering.permute_x(x), use_pallas=use_pallas)
        return reordering.restore_y(y)
    if isinstance(matrix, torch.Tensor) and matrix.dim() == 2:
        return matrix @ x
    if not isinstance(matrix, (CSR, ELL, BELL, DIA, HYB)):
        raise TypeError(f"unsupported matrix container: {type(matrix)}")
    if use_pallas:
        from repro_torch import plan as _plan

        p = _plan.DEFAULT_CACHE.get_or_build(
            _plan.matrix_fingerprint(matrix) + "|container",
            lambda: _plan.plan_for_container(matrix))
        return p.execute(x)
    from repro_torch.graph.semiring import PLUS_TIMES
    from repro_torch.plan.plan import container_spmv

    return container_spmv(matrix, x, PLUS_TIMES)


def power_iteration(matrix, x0: torch.Tensor, n_iters: int = 16,
                    use_pallas: bool = True):
    """Dominant-eigenpair estimate by repeated `spmv`, each result
    scaled by its norm (floored at 1e-30).  Returns (eigenvalue
    estimate, vector)."""
    x = torch.as_tensor(x0)
    lam = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(n_iters):
        y = spmv(matrix, x, use_pallas=use_pallas)
        lam = torch.linalg.vector_norm(y)
        x = y / torch.clamp(lam, min=1e-30)
    return lam, x


def pagerank(csr: CSR, damping: float = 0.85, n_iters: int = 32,
             use_pallas: bool = True, device=None) -> torch.Tensor:
    """PageRank for `n_iters` iterations with A's columns as out-edges:
    `graph.drivers.pagerank` (A[i, j] an edge i -> j) on the transpose,
    with `tol=0.0`.  The values come back as a tensor on `device`
    (None: the card)."""
    from repro_torch.graph.drivers import pagerank as _graph_pagerank
    from repro_torch.graph.drivers import transpose_csr

    res = _graph_pagerank(transpose_csr(csr), damping=damping, tol=0.0,
                          max_iters=n_iters, use_pallas=use_pallas,
                          device=device)
    return torch.from_numpy(np.array(res.values)).to(res.plan.device)


__all__ = ["auto_format", "spmv", "power_iteration", "pagerank"]
