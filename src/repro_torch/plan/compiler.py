"""`compile` -- turn a matrix into a frozen `SpmvPlan`.

Counterpart of `repro.plan.compiler`:

    fingerprint -> candidate reorderings -> per candidate: permute,
    structure.analyze, choose_format -> drop duplicate candidates ->
    score (cost model or oracle) -> winner -> convert -> prepared
    kernel layout -> SpmvPlan (on `device`)

The defaults are the reference's (`reorder="auto"`, `predictor="auto"`):
'auto' builds the identity and RCM candidates, and 'auto' scores them
with the shipped cost model (`plan.costmodel`, the port's own copy of
the artifact), or with the oracle when no model loads -- trace replay
through the contended-LLC simulator (`parallel.simulate_parallel`) up
to `REPLAY_NNZ_MAX` nonzeros, the analytic Che model
(`core.cache_model.analytic_metrics`) above.  Scores model the Sandy
Bridge machine the reference scores (`machine=SANDY_BRIDGE`), host-side
in numpy, in the reference's operation order, so the predicted GFLOPS,
the strict-`>` tie-breaks in sorted candidate order and the
`REORDER_MARGIN` rule give the reference's decision bit for bit.
Candidates are permuted where the matrix lies and analysed on the host;
only the chosen one is converted and laid out on `device`.
`compile_stats` carries the reference's keys, `["scoring"]` the
resolved mode ('model', 'replay', 'analytic' or 'none').  With `mesh=`
(a `distributed.RowMesh`) the chosen candidate becomes a row-sharded
plan ('ell-sharded'): one ELL slab per part of `partition` (default
`distributed.default_row_partition`), one `spmv_ell` launch per slab on
its device.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.core import structure
from repro_torch.core.cache_model import SANDY_BRIDGE, MachineModel
from repro_torch.core.formats import BELL, CSR, DIA, ELL, HYB
from repro_torch.device import resolve_device
from repro_torch.graph.semiring import SEMIRINGS, resolve
from repro_torch.kernels import _layout as kl
from repro_torch.kernels.spmv_csr_seg import WINDOW

from .fingerprint import matrix_fingerprint
from .plan import SpmvPlan

# 'oracle' scores by trace replay up to this nnz, analytically above
# (replay is Python-speed: ~5 trace entries per nonzero per sweep).
REPLAY_NNZ_MAX = 16384

# A reordered candidate must beat the identity ordering by this fraction
# of predicted throughput: the x gather and y scatter it pays per
# multiply are not in the stream-level scores.
REORDER_MARGIN = 0.02

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
    """label -> Reordering|None for the `reorder=` forms: 'auto' (none
    and rcm), 'none'/None, a strategy name, a strategy callable, or a
    concrete Reordering."""
    from repro_torch.reorder import STRATEGIES, Reordering

    if reorder is None or reorder == "none":
        return {"none": None}
    if reorder == "auto":
        return {"none": None, "rcm": STRATEGIES["rcm"](csr)}
    if isinstance(reorder, str):
        return {reorder: STRATEGIES[reorder](csr)}
    if isinstance(reorder, Reordering):
        return {reorder.strategy: reorder}
    if callable(reorder):
        r = reorder(csr)
        return {getattr(r, "strategy",
                        getattr(reorder, "__name__", "custom")): r}
    raise TypeError(f"unsupported reorder argument: {reorder!r}")


def _predict(csr: CSR, threads: int, machine: MachineModel,
             parallel_spec, predictor: str) -> Dict:
    """Predicted contended-LLC throughput of one candidate's stream
    ('replay' or 'analytic'; 'auto' picks by nnz)."""
    if predictor == "auto":
        predictor = "replay" if csr.nnz <= REPLAY_NNZ_MAX else "analytic"
    if predictor == "replay":
        from repro_torch.core.partition import rowblock_balanced
        from repro_torch.parallel import ParallelSpec, simulate_parallel

        spec = parallel_spec if parallel_spec is not None else ParallelSpec()
        part = rowblock_balanced(csr, threads)
        _, m = simulate_parallel(csr, part, machine, spec, sweeps=2)
        return {"predictor": "replay", "gflops": m.gflops_est(),
                "time_s": m.time_s, "dram_util": m.dram_util,
                "l2_mpki": m.l2_mpki_mean}
    if predictor == "analytic":
        from repro_torch.core.cache_model import analytic_metrics

        m = analytic_metrics(csr, machine, threads=threads)
        return {"predictor": "analytic", "gflops": m.gflops,
                "l2_mpki": m.l2_miss_rate,
                "dram_util": m.dram_utilization}
    raise ValueError(f"unknown predictor {predictor!r}")


def _resolve_predictor(predictor: str, nnz: int, stats: Dict):
    """(resolved mode, model or None): 'auto'/'model' -> 'model' when
    the shipped model loads, else the oracle ('model' then records
    `model_fallback`); 'oracle' -> 'replay' up to REPLAY_NNZ_MAX nnz,
    'analytic' above."""
    model = None
    if predictor in ("auto", "model"):
        from .costmodel import default_model

        model = default_model()
        if model is None:
            if predictor == "model":
                stats["model_fallback"] = 1.0
            predictor = "oracle"
        else:
            predictor = "model"
    if predictor == "oracle":
        predictor = "replay" if nnz <= REPLAY_NNZ_MAX else "analytic"
    return predictor, model


def _drop_duplicates(ordered, cands, permuted_by, fmt_by):
    """Drop candidates whose (permuted bytes, format) repeat another's --
    RCM of an already-banded matrix is the identity -- keeping 'none'
    first (it needs no x gather or y scatter)."""
    pref = [lab for lab in ("none",) if lab in cands] + \
        [lab for lab in ordered if lab != "none"]
    seen: Dict[object, str] = {}
    for label in pref:
        sig = (matrix_fingerprint(permuted_by[label]), fmt_by[label])
        seen.setdefault(sig, label)
    keep = set(seen.values())
    return [lab for lab in ordered if lab in keep]


def _score(ordered, predictor, model, report_by, permuted_by, *, threads,
           machine, parallel_spec, sample_rows) -> Dict[str, Dict]:
    """label -> predicted record of each candidate, in `ordered` order."""
    predicted: Dict[str, Dict] = {}
    if predictor == "model":
        import numpy as np

        from .costmodel import features_for

        l2b = getattr(parallel_spec, "l2_bytes", None)
        llcb = getattr(parallel_spec, "llc_bytes", None)
        feats = []
        for label in ordered:
            rep = report_by[label]
            if rep is None:
                # a forced format skipped the analysis; the model needs it
                rep = structure.analyze(permuted_by[label],
                                        sample_rows=sample_rows)
                report_by[label] = rep
            feats.append(features_for(rep, threads, l2_bytes=l2b,
                                      llc_bytes=llcb, machine=machine))
        scores = model.predict(np.stack(feats))
        for label, yhat in zip(ordered, scores):
            predicted[label] = {"predictor": "model",
                                "gflops": float(2.0 ** yhat)}
        return predicted
    for label in ordered:
        predicted[label] = _predict(permuted_by[label], threads, machine,
                                    parallel_spec, predictor)
    return predicted


def _winner(ordered, predicted) -> str:
    """First best in sorted order (strict >), and a reordered winner
    must clear 'none' by REORDER_MARGIN."""
    chosen = ordered[0]
    for label in ordered[1:]:
        if predicted[label]["gflops"] > predicted[chosen]["gflops"]:
            chosen = label
    if chosen != "none" and "none" in predicted:
        bar = predicted["none"]["gflops"] * (1.0 + REORDER_MARGIN)
        if predicted[chosen]["gflops"] <= bar:
            chosen = "none"
    return chosen


def compile(matrix: CSR, *,                       # noqa: A001 (plan.compile)
            threads: int = 1,
            mesh=None,
            partition=None,
            reorder="auto",
            machine: MachineModel = SANDY_BRIDGE,
            parallel_spec=None,
            predictor: str = "auto",
            format: Optional[str] = None,         # noqa: A002
            use_pallas: bool = True,
            semiring: str = "plus_times",
            bm: int = 128, n_stripes: int = 1, seg_len: int = WINDOW,
            keep_csr: bool = True,
            sample_rows: Optional[int] = 65536,
            device=None) -> SpmvPlan:
    """Compile a CSR matrix into a frozen `SpmvPlan` on `device` (None:
    the card; pass device="cpu" for the plain versions on the CPU).

    threads     thread count the scores model contention at (and, above
                1, biases dispersed matrices to 'csr-seg')
    reorder     'auto' (score 'none' against 'rcm') | 'none'/None | a
                strategy name (`reorder.STRATEGIES`) | a strategy
                callable | a concrete `Reordering`; the plan multiplies
                the permuted matrix and gathers x / scatters y so
                callers stay in the original order
    machine / parallel_spec   the simulated machine the scores model
                (the reference's Sandy Bridge by default) and the
                replay's geometry (`parallel.ParallelSpec`)
    predictor   'auto' | 'model' | 'oracle' | 'replay' | 'analytic' |
                'none' (keep the single candidate; with reorder='auto'
                it is the identity order)
    format      force 'dia'|'bell'|'ell'|'csr'|'csr-seg'|'hyb'; default
                reads it off each candidate's permuted structure report
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
    mesh / partition   a `distributed.RowMesh`: build a row-sharded
                plan over `partition` (a `RowPartition` with one part
                per mesh device); the plan lives on the mesh's first
                device unless `device` says otherwise
    """
    if mesh is not None:
        from repro_torch.distributed.spmv import RowMesh

        if not isinstance(mesh, RowMesh):
            raise TypeError("mesh must be a repro_torch.distributed.RowMesh "
                            f"(distributed.row_mesh), got "
                            f"{type(mesh).__name__}")
        if device is None:
            device = mesh.devices[0]
    dev = resolve_device(device)
    sr = resolve(semiring)
    if SEMIRINGS.get(sr.name) is not sr:
        raise ValueError(f"semiring {sr.name!r} is not registered in "
                         "repro_torch.graph.semiring.SEMIRINGS")
    if mesh is not None and sr.name != "plus_times":
        raise ValueError("sharded plans are plus-times only")
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
    if predictor == "none" and reorder == "auto":
        # no scoring requested, so no candidate could be chosen by a
        # score: 'auto' degenerates to the identity order
        reorder = "none"
    predictor, model = _resolve_predictor(predictor, matrix.nnz, stats)

    t0 = time.perf_counter()
    cands = _candidates(matrix, reorder)
    permuted_by = {label: (r.apply(matrix) if r is not None else matrix)
                   for label, r in cands.items()}
    stats["reorder_s"] = time.perf_counter() - t0

    # one (format, reordering) pair per candidate, sorted by name so the
    # enumeration and every tie-break are deterministic
    fmt_by: Dict[str, str] = {}
    report_by: Dict[str, object] = {}
    t0 = time.perf_counter()
    for label in sorted(cands):
        if format is not None:
            fmt_by[label], report_by[label] = format, None
        else:
            rep = structure.analyze(permuted_by[label],
                                    sample_rows=sample_rows)
            report_by[label] = rep
            fmt_by[label] = choose_format(rep, threads=threads,
                                          semiring_safe=semiring_safe)
    if format is None:
        stats["analyze_s"] = time.perf_counter() - t0
    ordered = sorted(cands, key=lambda lab: (fmt_by[lab], lab))
    if len(ordered) > 1:
        ordered = _drop_duplicates(ordered, cands, permuted_by, fmt_by)

    t0 = time.perf_counter()
    predicted: Dict[str, Dict] = {}
    if predictor == "none" or len(ordered) == 1:
        chosen = ordered[0]
        stats["scoring"] = "none"
    else:
        predicted = _score(ordered, predictor, model, report_by,
                           permuted_by, threads=threads, machine=machine,
                           parallel_spec=parallel_spec,
                           sample_rows=sample_rows)
        chosen = _winner(ordered, predicted)
        stats["scoring"] = predictor
    stats["predict_s"] = time.perf_counter() - t0

    reordering, permuted = cands[chosen], permuted_by[chosen]
    report, format_name = report_by[chosen], fmt_by[chosen]
    if reordering is not None:
        # the gather / scatter indices go to the card now, not in the
        # first execute
        reordering.index("col_perm", dev)
        reordering.index("inv_row_perm", dev)

    if mesh is not None:
        return _compile_sharded(fp, permuted, reordering, report, mesh,
                                partition, bm=bm, threads=threads,
                                predicted=predicted, chosen=chosen,
                                stats=stats, keep_csr=keep_csr, dev=dev)

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
        use_pallas=use_pallas, semiring=sr.name, predicted=predicted,
        chosen=chosen, compile_stats=stats)


def _compile_sharded(fp, permuted, reordering, report, mesh, partition, *,
                     bm, threads, predicted, chosen, stats, keep_csr,
                     dev) -> SpmvPlan:
    """Row-sharded plan: `prepare_ell_shards` on the host, then each
    slab's slot-major transpose on its mesh device."""
    from repro_torch.distributed.spmv import default_row_partition

    t0 = time.perf_counter()
    if partition is None:
        partition = default_row_partition(permuted, mesh)
    if getattr(partition, "starts", None) is None:
        raise TypeError("partition must be a core.partition.RowPartition, "
                        f"got {type(partition).__name__}")
    if partition.n_parts != mesh.n_shards:
        raise ValueError(f"partition has {partition.n_parts} parts for "
                         f"{mesh.n_shards} devices on axis 'shards'")
    prep = kl.prepare_ell_shards(permuted, partition, bm=bm)
    prep.slabs(mesh.devices)
    stats["prepare_s"] = time.perf_counter() - t0
    return SpmvPlan(
        fingerprint=fp, format_name="ell-sharded", container=None,
        prep=prep, device=dev, reordering=reordering, report=report,
        csr=permuted.to(dev) if keep_csr else None, threads=threads,
        use_pallas=True, predicted=predicted, chosen=chosen,
        compile_stats=stats, mesh=mesh)


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
           "HYB_MIN_CV", "SEG_MIN_CV", "SEMIRING_FORMATS", "FORMATS",
           "REPLAY_NNZ_MAX", "REORDER_MARGIN"]
