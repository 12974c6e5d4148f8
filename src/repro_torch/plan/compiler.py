"""`compile` -- turn a matrix into a frozen `SpmvPlan`.

Counterpart of `repro.plan.compiler` for the unscored path:

    fingerprint -> structure.analyze -> choose_format -> convert
                -> prepared kernel layout -> SpmvPlan (on `device`)

`choose_format` is the reference's rule, so for the same matrix the two
packages pick the same format.  This slice compiles with
`predictor="none"` and `reorder="none"` (`reorder="auto"` degenerates to
"none" without a predictor, as in the reference); candidate scoring
(ROADMAP A9), reordering (A4), sharded plans (A10) and BELL (B5) raise
`NotImplementedError` until their slices land.  `compile_stats` carries
the reference's keys.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.core import structure
from repro_torch.core.formats import CSR, DIA, ELL, HYB
from repro_torch.device import resolve_device
from repro_torch.graph.semiring import SEMIRINGS, resolve
from repro_torch.kernels import _layout as kl

from .fingerprint import matrix_fingerprint
from .plan import SpmvPlan

# Power-law detection (the reference's constants): above HYB_MIN_CV an
# unstructured matrix takes the hybrid row split; between SEG_MIN_CV and
# HYB_MIN_CV a multithreaded plan takes the segmented layout.
HYB_MIN_CV = 1.0
SEG_MIN_CV = 0.5

# Semiring plans need absorbing padding, which DIA (and BELL) cannot hold.
SEMIRING_FORMATS = ("csr", "csr-seg", "ell", "hyb")
FORMATS = ("dia", "ell", "csr", "csr-seg", "hyb")


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
    if format_name in ("csr", "csr-seg"):
        return csr if device is None else csr.to(device)
    if format_name == "bell":
        raise _not_in_slice("the BELL format", "B5")
    raise ValueError(f"unknown format {format_name!r}")


def _prepare(container, format_name: str, *, bm: int, n_stripes: int,
             seg_len: int, semiring):
    if format_name == "dia":
        return kl.prepare_dia(container)
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


def compile(matrix: CSR, *,                       # noqa: A001 (plan.compile)
            threads: int = 1,
            mesh=None,
            partition=None,
            reorder="none",
            predictor: str = "none",
            format: Optional[str] = None,         # noqa: A002
            use_pallas: bool = True,
            semiring: str = "plus_times",
            bm: int = 128, n_stripes: int = 1, seg_len: int = 512,
            keep_csr: bool = True,
            sample_rows: Optional[int] = 65536,
            device=None) -> SpmvPlan:
    """Compile a CSR matrix into a frozen `SpmvPlan` on `device` (None:
    the card; pass device="cpu" for the plain versions on the CPU).

    format      force 'dia'|'ell'|'csr'|'csr-seg'|'hyb'; default reads it
                off the structure report (`choose_format`)
    use_pallas  True runs the prepared layout through the kernels; False
                keeps no layout and runs the container's plain oracle
                (the reference's name, kept so cache keys agree)
    semiring    name or `Semiring` of the (⊕, ⊗) pair; non-plus-times
                plans use the absorbing-pad formats only
    bm / n_stripes / seg_len   padded-CSR row block and column stripes,
                nonzeros per segment of the 'csr-seg'/'hyb' layouts
    keep_csr    keep the CSR on the plan
    """
    if mesh is not None or partition is not None:
        raise _not_in_slice("sharded plans (mesh=, partition=)", "A10")
    if predictor != "none":
        raise _not_in_slice(f"predictor={predictor!r}", "A9")
    if reorder not in ("none", None, "auto"):
        raise _not_in_slice(f"reorder={reorder!r}", "A4")
    dev = resolve_device(device)
    sr = resolve(semiring)
    if SEMIRINGS.get(sr.name) is not sr:
        raise ValueError(f"semiring {sr.name!r} is not registered in "
                         "repro_torch.graph.semiring.SEMIRINGS")
    if format is not None and format not in FORMATS:
        if format == "bell":
            raise _not_in_slice("the BELL format", "B5")
        raise ValueError(f"unknown format {format!r}")
    semiring_safe = sr.name != "plus_times"
    if semiring_safe and format is not None and \
            format not in SEMIRING_FORMATS:
        raise ValueError(
            f"semiring {sr.name!r} requires a format in {SEMIRING_FORMATS} "
            f"({format!r} stores absent entries as 0.0, which is only "
            "absorbing under plus_times)")

    fp = matrix_fingerprint(matrix)
    stats: Dict[str, object] = {"reorder_s": 0.0}
    report = None
    if format is None:
        t0 = time.perf_counter()
        report = structure.analyze(matrix, sample_rows=sample_rows)
        format_name = choose_format(report, threads=threads,
                                    semiring_safe=semiring_safe)
        stats["analyze_s"] = time.perf_counter() - t0
    else:
        format_name = format
    stats["scoring"] = "none"
    stats["predict_s"] = 0.0

    t0 = time.perf_counter()
    container = convert(matrix, format_name, fill=sr.pad_value, device=dev)
    stats["convert_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    prep = _prepare(container, format_name, bm=bm, n_stripes=n_stripes,
                    seg_len=seg_len, semiring=sr) if use_pallas else None
    stats["prepare_s"] = time.perf_counter() - t0

    return SpmvPlan(
        fingerprint=fp, format_name=format_name, container=container,
        prep=prep, device=dev, report=report,
        csr=matrix.to(dev) if keep_csr else None, threads=threads,
        use_pallas=use_pallas, semiring=sr.name, chosen="none",
        compile_stats=stats)


__all__ = ["compile", "choose_format", "convert", "HYB_MIN_CV",
           "SEG_MIN_CV", "SEMIRING_FORMATS"]
