"""`compile` -- turn a matrix into a frozen `SpmvPlan`.

Counterpart of `repro.plan.compiler` for the unscored path:

    fingerprint -> reordering -> structure.analyze (of the permuted
    matrix) -> choose_format -> convert -> prepared kernel layout
    -> SpmvPlan (on `device`)

`choose_format` is the reference's rule and `_candidates` its reading
of `reorder=`, so for the same matrix and options the two packages pick
the same format and the same reordering.  The port compiles with
`predictor="none"` and `reorder="none"` by default (the reference's
defaults are "auto"/"auto"): `reorder="auto"` with `predictor="none"`
degenerates to "none", as in the reference; scoring more than one
candidate (ROADMAP A9) and sharded plans (A10) raise
`NotImplementedError`.  `compile_stats` carries the reference's keys.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.core import structure
from repro_torch.core.formats import BELL, CSR, DIA, ELL, HYB
from repro_torch.device import resolve_device
from repro_torch.graph.semiring import SEMIRINGS, resolve
from repro_torch.kernels import _layout as kl
from repro_torch.kernels.spmv_csr_seg import WINDOW

from .fingerprint import matrix_fingerprint
from .plan import SpmvPlan

# Power-law detection (the reference's constants): above HYB_MIN_CV an
# unstructured matrix takes the hybrid row split; between SEG_MIN_CV and
# HYB_MIN_CV a multithreaded plan takes the segmented layout.
HYB_MIN_CV = 1.0
SEG_MIN_CV = 0.5

# Semiring plans need absorbing padding, which DIA and BELL cannot hold.
SEMIRING_FORMATS = ("csr", "csr-seg", "ell", "hyb")
FORMATS = ("dia", "bell", "ell", "csr", "csr-seg", "hyb")


def choose_format(report, threads: int = 1,
                  semiring_safe: bool = False) -> str:
    """Format name for a structure report (the reference's rule)."""
    if not semiring_safe:
        if report.kind == "banded" and report.n_distinct_offsets <= 64:
            return "dia"
        if report.kind == "blocked":
            return "bell"
    if report.kind == "unstructured":
        if report.row_nnz_cv >= HYB_MIN_CV:
            return "hyb"
        if threads > 1 and report.row_nnz_cv >= SEG_MIN_CV:
            return "csr-seg"
    return "ell" if semiring_safe else "csr"


def _not_in_slice(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP {item})")


def convert(csr: CSR, format_name: str, fill: float = 0.0, device=None):
    """Convert a CSR to the named container on `device` (default: the
    CSR's).  'csr-seg' is a layout over the CSR itself."""
    if format_name == "dia":
        return DIA.from_csr(csr, device=device)
    if format_name == "ell":
        return ELL.from_csr(csr, fill=fill, device=device)
    if format_name == "hyb":
        return HYB.from_csr(csr, fill=fill, device=device)
    if format_name == "bell":
        return BELL.from_csr(csr, device=device)
    if format_name in ("csr", "csr-seg"):
        return csr if device is None else csr.to(device)
    raise ValueError(f"unknown format {format_name!r}")


def _prepare(container, format_name: str, *, bm: int, n_stripes: int,
             seg_len: int, semiring):
    if format_name == "dia":
        return kl.prepare_dia(container)
    if format_name == "bell":
        return kl.prepare_bell(container)
    if format_name == "ell":
        return kl.prepare_ell(container, semiring)
    if format_name == "csr":
        return kl.prepare_csr(container, n_stripes=n_stripes, bm=bm,
                              semiring=semiring)
    if format_name == "csr-seg":
        return kl.prepare_csr_seg(container, seg_len=seg_len)
    if format_name == "hyb":
        return kl.prepare_hyb(container, seg_len=seg_len, semiring=semiring)
    raise ValueError(f"unknown format {format_name!r}")


def _candidates(csr: CSR, reorder) -> Dict[str, object]:
    """label -> Reordering|None for the `reorder=` forms: 'none'/None, a
    strategy name, a strategy callable, or a concrete Reordering (one
    candidate each; 'auto', which adds RCM beside 'none' for a scorer to
    choose between, is resolved by `compile` before this)."""
    from repro_torch.reorder import STRATEGIES, Reordering

    if reorder is None or reorder == "none":
        return {"none": None}
    if isinstance(reorder, str):
        return {reorder: STRATEGIES[reorder](csr)}
    if isinstance(reorder, Reordering):
        return {reorder.strategy: reorder}
    if callable(reorder):
        r = reorder(csr)
        return {getattr(r, "strategy",
                        getattr(reorder, "__name__", "custom")): r}
    raise TypeError(f"unsupported reorder argument: {reorder!r}")


def compile(matrix: CSR, *,                       # noqa: A001 (plan.compile)
            threads: int = 1,
            mesh=None,
            partition=None,
            reorder="none",
            predictor: str = "none",
            format: Optional[str] = None,         # noqa: A002
            use_pallas: bool = True,
            semiring: str = "plus_times",
            bm: int = 128, n_stripes: int = 1, seg_len: int = WINDOW,
            keep_csr: bool = True,
            sample_rows: Optional[int] = 65536,
            device=None) -> SpmvPlan:
    """Compile a CSR matrix into a frozen `SpmvPlan` on `device` (None:
    the card; pass device="cpu" for the plain versions on the CPU).

    reorder     'none'/None | a strategy name (`reorder.STRATEGIES`) | a
                strategy callable | a concrete `Reordering`; the plan
                multiplies the permuted matrix and gathers x / scatters y
                so callers stay in the original order.  'auto' needs a
                predictor (ROADMAP A9) and with predictor="none" is 'none'
    format      force 'dia'|'bell'|'ell'|'csr'|'csr-seg'|'hyb'; default
                reads it off the permuted matrix's structure report
                (`choose_format`)
    use_pallas  True runs the prepared layout through the kernels; False
                keeps no layout and runs the container's plain oracle
                (the reference's name, kept so cache keys agree)
    semiring    name or `Semiring` of the (⊕, ⊗) pair; non-plus-times
                plans use the absorbing-pad formats only
    bm / n_stripes / seg_len   padded-CSR row block and column stripes,
                merge-path items (row ends and nonzeros) per window
                of the 'csr-seg'/'hyb' layouts
    keep_csr    keep the permuted CSR on the plan
    """
    if mesh is not None or partition is not None:
        raise _not_in_slice("sharded plans (mesh=, partition=)", "A10")
    if predictor != "none":
        raise _not_in_slice(f"predictor={predictor!r}", "A9")
    if reorder == "auto":
        # no scoring requested, so no candidate could be chosen by a
        # score: 'auto' degenerates to the identity order
        reorder = "none"
    dev = resolve_device(device)
    sr = resolve(semiring)
    if SEMIRINGS.get(sr.name) is not sr:
        raise ValueError(f"semiring {sr.name!r} is not registered in "
                         "repro_torch.graph.semiring.SEMIRINGS")
    if format is not None and format not in FORMATS:
        raise ValueError(f"unknown format {format!r}")
    semiring_safe = sr.name != "plus_times"
    if semiring_safe and format is not None and \
            format not in SEMIRING_FORMATS:
        raise ValueError(
            f"semiring {sr.name!r} requires a format in {SEMIRING_FORMATS} "
            f"({format!r} stores absent entries as 0.0, which is only "
            "absorbing under plus_times)")

    fp = matrix_fingerprint(matrix)
    stats: Dict[str, object] = {}
    t0 = time.perf_counter()
    cands = _candidates(matrix, reorder)
    (chosen, reordering), = cands.items()
    permuted = matrix
    if reordering is not None:
        permuted = reordering.apply(matrix)
        # the gather / scatter indices go to the card now, not in the
        # first execute
        reordering.index("col_perm", dev)
        reordering.index("inv_row_perm", dev)
    stats["reorder_s"] = time.perf_counter() - t0

    report = None
    if format is None:
        t0 = time.perf_counter()
        report = structure.analyze(permuted, sample_rows=sample_rows)
        format_name = choose_format(report, threads=threads,
                                    semiring_safe=semiring_safe)
        stats["analyze_s"] = time.perf_counter() - t0
    else:
        format_name = format
    stats["scoring"] = "none"
    stats["predict_s"] = 0.0

    t0 = time.perf_counter()
    container = convert(permuted, format_name, fill=sr.pad_value,
                        device=dev)
    stats["convert_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    prep = _prepare(container, format_name, bm=bm, n_stripes=n_stripes,
                    seg_len=seg_len, semiring=sr) if use_pallas else None
    stats["prepare_s"] = time.perf_counter() - t0

    return SpmvPlan(
        fingerprint=fp, format_name=format_name, container=container,
        prep=prep, device=dev, reordering=reordering, report=report,
        csr=permuted.to(dev) if keep_csr else None, threads=threads,
        use_pallas=use_pallas, semiring=sr.name, chosen=chosen,
        compile_stats=stats)


def plan_for_container(matrix) -> SpmvPlan:
    """Minimal plan for an already-converted container (no analysis, no
    reordering: the caller chose the format), on the container's device:
    only the one-time kernel layout.  `core.spmv.spmv` caches these."""
    names = {DIA: "dia", BELL: "bell", ELL: "ell", CSR: "csr", HYB: "hyb"}
    format_name = names[type(matrix)]
    dev = matrix.data.device
    prep = _prepare(matrix, format_name, bm=128, n_stripes=1, seg_len=WINDOW,
                    semiring=resolve(None))
    return SpmvPlan(
        fingerprint=matrix_fingerprint(matrix), format_name=format_name,
        container=matrix, prep=prep, device=dev,
        csr=matrix if isinstance(matrix, CSR) else None,
        chosen="container")


__all__ = ["compile", "choose_format", "convert", "plan_for_container",
           "HYB_MIN_CV", "SEG_MIN_CV", "SEMIRING_FORMATS", "FORMATS"]
