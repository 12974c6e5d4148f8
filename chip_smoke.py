#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

It builds the four hand-written CUDA kernels from `src/repro_torch/
kernels/csrc/` and then runs these phases, one output line per step:

  device   the card's name and power limit (as nvidia-smi gives them)
           and the kernels' build time;
  small    FD and R-MAT at 2^10 on the card against the port's CPU path,
           which also loads every library before anything is timed;
  main     the main path at 2^22 rows: `fd_matrix` and `rmat_matrix`,
           each of the four graph drivers through the kernels, with every
           launch count set to 0 just before and read just after; then
           the same runs on the plain PyTorch path (use_pallas=False) on
           the card: same iteration counts, BFS/SSSP/CC values equal,
           PageRank within rtol 1e-3 (values near 2^-22);
  dia      FD PageRank at 2^16, where the compiler picks DIA, counted the
           same way, against its plain path;
  kernel   each kernel against its plain version on the card, on the
           main path's layouts, under every semiring it serves:
           bit-identical on integer-valued plus-times operands, equal
           under min_plus / or_and / max_times (+-inf included), within
           rtol 1e-5 / atol 1e-6 on real-valued plus-times;
  time     per kernel at the main path's shapes: CUDA-event time of many
           launches, its plain version's time, a torch.sparse CSR
           product's time where one computes the same function, and the
           bound: the larger of the bytes the kernel's function must
           move (its inputs read once, y written once) at 3.35 TB/s and
           its float32 operations at 67 TFLOP/s.  DIA moves its band,
           ELL its (W, n) slab, padded CSR its nonzeros and row
           pointers, segmented CSR its heavy nonzeros and the base.
           The uniform 8 nnz + 12 n bytes of the unpadded CSR is
           printed beside it as `csr_bound_ms`.

Then one JSON line `{"kernels": [...]}` and, last,
`{"ok": true, "device": {...}}`.  It exits nonzero and prints no result
without a card, outside a checkout, or when any check fails.
`--cpu-rehearsal` runs every phase at a small size on the CPU through
the plain versions (no kernels, so no result either) to rehearse the
control flow.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory, data sheet
F32_OPS_PER_S = 67e12               # H100 SXM float32 outside tensor cores
FD_CAP = 1100                       # max_iters of FD bfs/sssp/cc
PR_TOL = 1e-5                       # PageRank L1 residual tolerance
PR_RTOL = 1e-3                      # PageRank kernel vs plain, values
REAL_RTOL, REAL_ATOL = 1e-5, 1e-6   # real-valued plus-times, kernel/plain
TPU_KERNELS = {
    "spmv_dia": "src/repro/kernels/spmv_dia.py:48",
    "spmv_ell": "src/repro/kernels/spmv_ell.py:46",
    "spmv_csr": "src/repro/kernels/spmv_csr.py:62",
    "spmv_csr_seg": "src/repro/kernels/spmv_csr_seg.py:67",
}
ANALYTICS = ("pagerank", "bfs", "sssp", "connected_components")

FAILURES: list = []


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> bool:
    if not ok:
        FAILURES.append(what)
        log(f"FAIL {what}")
    return ok


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# main path: the four drivers on both families
# ---------------------------------------------------------------------------

def drive(drivers, fam, adj, cache, dev, use_pallas):
    """Run the four drivers on one graph; returns {analytic: (result,
    wall seconds)}."""
    src = int(np.argmax(adj.row_lengths()))
    r0 = np.random.default_rng(7).uniform(0.5, 1.5, adj.n_rows) \
        .astype(np.float32)
    cap = FD_CAP if fam == "fd" else None
    kw = dict(plan_cache=cache, use_pallas=use_pallas, device=dev)
    calls = {
        "pagerank": lambda: drivers.pagerank(adj, tol=PR_TOL, r0=r0, **kw),
        "bfs": lambda: drivers.bfs(adj, src, max_iters=cap, **kw),
        "sssp": lambda: drivers.sssp(adj, src, max_iters=cap, **kw),
        "connected_components": lambda: drivers.connected_components(
            adj, max_iters=cap, **kw),
    }
    out = {}
    for name in ANALYTICS:
        t0 = time.perf_counter()
        res = calls[name]()
        sync(dev)
        out[name] = (res, time.perf_counter() - t0)
    return out


def compile_seconds(plan) -> float:
    return sum(v for k, v in plan.compile_stats.items()
               if k.endswith("_s"))


def spmv_ms(plan, dev) -> float:
    """Device time of one `plan.execute`, the SpMV of one iteration
    (CUDA events; the kernels do the same work whatever x holds)."""
    x = torch.ones(plan.n_cols, device=dev)
    return time_ms(lambda: plan.execute(x), 20, dev)


def report_run(tag, fam, name, res, wall, cap=None, spmv=None):
    """One driver run: format, iterations, host compile seconds, host
    wall time per iteration (SpMV, stepper and the one read back) and,
    when given, the SpMV's device time per iteration."""
    it = max(res.n_iters, 1)
    iter_ms = 1e3 * res.iter_s / it
    log(f"{tag} {fam} {name}: fmt={res.plan.format_name} "
        f"iters={res.n_iters} converged={res.converged}"
        f"{f' max_iters={cap}' if cap else ''} "
        f"compile_s={compile_seconds(res.plan):.3f} wall_s={wall:.3f} "
        f"iter_ms={iter_ms:.4f}"
        + ("" if spmv is None else
           f" spmv_device_ms={spmv:.4f} spmv_share={spmv / iter_ms:.3f}"))


def compare_pagerank(tag, a, b):
    """Kernel-path PageRank `a` against plain-path `b`: finite, values
    within PR_RTOL of each other, summing to 1."""
    err = float(np.max(np.abs(a.values - b.values) /
                       np.maximum(np.abs(b.values), 1e-30)))
    check(np.isfinite(a.values).all() and err <= PR_RTOL and
          abs(float(a.values.sum()) - 1.0) < 1e-3,
          f"{tag} pagerank: max rel err {err:.3g}")
    log(f"{tag} pagerank: kernels vs plain max rel err {err:.3g} "
        f"(rtol {PR_RTOL}), sum {float(a.values.sum()):.6f}")


def compare_runs(tag, kern, plain):
    for name in ANALYTICS:
        a, b = kern[name][0], plain[name][0]
        check(a.n_iters == b.n_iters,
              f"{tag} {name}: iterations {a.n_iters} (kernels) vs "
              f"{b.n_iters} (plain)")
        if name == "pagerank":
            compare_pagerank(tag, a, b)
        else:
            same = np.array_equal(a.values, b.values)
            check(same, f"{tag} {name}: values differ from the plain path")
            log(f"{tag} {name}: kernels == plain: {same}, "
                f"finite={int(np.isfinite(a.values).sum())}")


# ---------------------------------------------------------------------------
# kernel vs plain on the card
# ---------------------------------------------------------------------------

def x_for(sr_name, n, gen, dev, kind="int"):
    """A vector in the semiring's domain; min_plus gets some +inf."""
    def ints(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen).float()
    if sr_name == "plus_times":
        x = ints(-8, 9) if kind == "int" else torch.rand(n, generator=gen)
    elif sr_name == "or_and":
        x = ints(0, 2)
    elif sr_name == "max_times":
        x = ints(0, 9)
    else:
        x = torch.rand(n, generator=gen) * 100
        x[torch.rand(n, generator=gen) < 0.1] = float("inf")
    return x.to(dev)


def int_values(vals, sr_name, gen):
    """Integer-valued copy of a layout's values; padding slots (the
    plus-times pad 0.0 / min_plus pad +inf) are kept as they are."""
    real = (vals != 0.0) & torch.isfinite(vals)
    lo = 1 if sr_name in ("or_and", "max_times") else -8
    hi = 2 if sr_name == "or_and" else 9
    ints = torch.randint(lo, hi, vals.shape, generator=gen).float()
    ints[ints == 0] = 1
    return torch.where(real, ints.to(vals.device), vals)


def compare(errs, kname, label, got, want, exact):
    finite = torch.isfinite(want)
    inf_ok = torch.equal(torch.isinf(got), torch.isinf(want)) and \
        torch.equal(got[~finite], want[~finite])
    err = float((got[finite] - want[finite]).abs().max()) \
        if finite.any() else 0.0
    if exact:
        ok = torch.equal(got, want)
    else:
        ok = inf_ok and torch.allclose(got, want, rtol=REAL_RTOL,
                                       atol=REAL_ATOL)
    errs.setdefault(kname, 0.0)
    errs[kname] = max(errs[kname], err)
    check(ok, f"kernel {kname} {label}: differs from its plain version "
              f"(max abs err {err:.3g})")
    log(f"kernel {kname} {label}: n={got.shape[0]} "
        f"{'bit-identical' if exact else f'rtol {REAL_RTOL}'} ok={ok} "
        f"max_abs_err={err:.3g}")


def kernel_vs_plain(K, SR, plans, dev):
    """Every kernel on the main path's layouts against its plain
    version.  Returns {kernel: max abs error}."""
    gen = torch.Generator().manual_seed(0)
    errs: dict = {}
    fd_pr, dia_pr = plans[("fd", "pagerank")], plans[("dia", "pagerank")]

    # DIA: plus-times only
    p = dia_pr.prep
    n = p.n_cols
    for kind in ("int", "real"):
        band = int_values(p.band, "plus_times", gen) if kind == "int" \
            else p.band
        x = x_for("plus_times", n, gen, dev, kind)
        compare(errs, "spmv_dia", f"fd2^{n.bit_length() - 1} {kind}",
                K.spmv_dia(band, p.offsets, x, n),
                K.spmv_dia_plain(band, p.offsets, x, n), exact=True)

    # padded CSR: the FD PageRank layout under every semiring
    p = fd_pr.prep
    for sr_name in SR:
        for kind in (("int", "real") if sr_name == "plus_times"
                     else ("int",)):
            vals = p.vals if kind == "real" else \
                int_values(p.vals, sr_name, gen)
            x = x_for(sr_name, p.n_cols, gen, dev, kind)
            args = (vals, p.cols, p.rowptr, x, p.n_rows, SR[sr_name])
            compare(errs, "spmv_csr", f"fd pagerank {sr_name} {kind}",
                    K.spmv_csr(*args), K.spmv_csr_plain(*args),
                    exact=kind == "int")

    # ELL: FD's semiring layouts and every R-MAT light slab
    ell_cases = [(("fd", a), plans[("fd", a)].prep) for a in
                 ("bfs", "sssp", "connected_components")]
    ell_cases += [(("rmat", a), plans[("rmat", a)].prep.light)
                  for a in ANALYTICS]
    for (fam, a), lp in ell_cases:
        sr_name = plans[(fam, a)].semiring
        kinds = ("int", "real") if sr_name == "plus_times" else ("real",)
        for kind in kinds:
            data = int_values(lp.data, sr_name, gen) if kind == "int" \
                else lp.data
            x = x_for(sr_name, lp.n_cols, gen, dev, kind)
            args = (data, lp.idx, x, SR[sr_name])
            compare(errs, "spmv_ell", f"{fam} {a} {sr_name} {kind}",
                    K.spmv_ell(*args), K.spmv_ell_plain(*args),
                    exact=kind == "int" or sr_name != "plus_times")
    lp = plans[("fd", "bfs")].prep
    data = int_values(lp.data, "max_times", gen)
    x = x_for("max_times", lp.n_cols, gen, dev)
    args = (data, lp.idx, x, SR["max_times"])
    compare(errs, "spmv_ell", "fd bfs max_times int", K.spmv_ell(*args),
            K.spmv_ell_plain(*args), exact=True)

    # segmented CSR: every R-MAT heavy stream, joined with a base
    for a in ANALYTICS:
        hp = plans[("rmat", a)].prep.heavy
        sr_name = plans[("rmat", a)].semiring
        cases = [(sr_name, "int"), (sr_name, "real")] \
            if sr_name == "plus_times" else [(sr_name, "real")]
        if a == "pagerank":
            cases.append(("max_times", "int"))
        for name, kind in cases:
            vals = int_values(hp.vals, name, gen) if kind == "int" \
                else hp.vals
            x = x_for(name, hp.n_cols, gen, dev, kind)
            base = x_for(name, hp.n_rows, gen, dev, kind)
            args = (dataclasses.replace(hp, vals=vals), x, SR[name])
            compare(errs, "spmv_csr_seg", f"rmat {a} {name} {kind}",
                    K.spmv_csr_seg(*args, base=base),
                    K.spmv_csr_seg_plain(*args, base=base),
                    exact=kind == "int" or name != "plus_times")
    return errs


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int, dev) -> float:
    for _ in range(3):
        fn()
    sync(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sparse_csr(rows, cols, vals, n_rows, n_cols):
    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]),
                                  vals, (n_rows, n_cols))
    return coo.coalesce().to_sparse_csr()


def layout_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def timings(K, SR, plans, dev, reps):
    """{kernel: dict(ms, plain_ms, library_ms, bound_ms, shape, pad)}."""
    gen = torch.Generator().manual_seed(1)
    out = {}

    def entry(name, kern, plain, lib, need_bytes, ops, nnz, n, tensors,
              label, key=None):
        """`need_bytes`: what this kernel's function must move, each input
        read once and each output written once; `ops`: its ⊗ and ⊕."""
        unpadded = 8 * nnz + 4 * (n + 1)
        bytes_ms = 1e3 * need_bytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / F32_OPS_PER_S
        bound = max(bytes_ms, ops_ms)
        # the uniform yardstick: 8 nnz + 12 n bytes of the unpadded CSR
        csr_bound = 1e3 * (8 * nnz + 12 * n) / HBM_BYTES_PER_S
        ms = time_ms(kern, reps, dev)
        plain_ms = time_ms(plain, max(reps // 10, 2), dev)
        lib_ms = time_ms(lib, reps, dev) if lib is not None else None
        out[key or name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        log(f"time {name} [{label}]: n={n} nnz={nnz} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms="
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_bytes={need_bytes} bound_ms={bound:.4f} "
            f"({ms / bound:.2f}x bound) csr_bound_ms={csr_bound:.4f} "
            f"layout/unpadded_csr_bytes="
            f"{layout_bytes(*tensors) / unpadded:.3f}")

    pt = SR["plus_times"]
    plan = plans[("dia", "pagerank")]
    p, c = plan.prep, plan.csr
    x = torch.rand(p.n_cols, generator=gen).to(dev)
    A = sparse_csr(*_coo(c), c.n_rows, c.n_cols)
    D = p.band.shape[0]
    entry("spmv_dia", lambda: K.spmv_dia(p.band, p.offsets, x, p.n_cols),
          lambda: K.spmv_dia_plain(p.band, p.offsets, x, p.n_cols),
          lambda: A @ x, layout_bytes(p.band, p.offsets) + 4 * p.n_cols
          + 4 * p.n_rows, 2 * D * p.n_rows, c.nnz, c.n_rows,
          (p.band, p.offsets), f"fd pagerank, plus_times, {D} diagonals")

    # ELL reads every slot of its (W, n) slab; timed under plus-times
    # (the R-MAT PageRank light slab's semiring), where torch.sparse
    # computes the same function, and under or_and (FD BFS)
    plan = plans[("fd", "bfs")]
    lp, c = plan.prep, plan.csr
    W = lp.data.shape[0]
    A = sparse_csr(*_coo(c), c.n_rows, c.n_cols)
    ell_bytes = layout_bytes(lp.data, lp.idx) + 4 * lp.n_cols + 4 * lp.n_rows
    for sr_name, key in (("plus_times", "spmv_ell"),
                         ("or_and", "spmv_ell or_and")):
        x = x_for(sr_name, lp.n_cols, gen, dev, "real")
        sr = SR[sr_name]
        entry("spmv_ell", lambda: K.spmv_ell(lp.data, lp.idx, x, sr),
              lambda: K.spmv_ell_plain(lp.data, lp.idx, x, sr),
              (lambda: A @ x) if sr_name == "plus_times" else None,
              ell_bytes, 2 * W * lp.n_rows, c.nnz, c.n_rows,
              (lp.data, lp.idx), f"fd bfs layout, {sr_name}, W={W}", key)

    # padded CSR: each row walks its own slots, so no padding slot is read
    plan = plans[("fd", "pagerank")]
    cp, c = plan.prep, plan.csr
    x = torch.rand(cp.n_cols, generator=gen).to(dev)
    A = sparse_csr(*_coo(c), c.n_rows, c.n_cols)
    args = (cp.vals, cp.cols, cp.rowptr, x, cp.n_rows, pt)
    entry("spmv_csr", lambda: K.spmv_csr(*args),
          lambda: K.spmv_csr_plain(*args), lambda: A @ x,
          8 * c.nnz + layout_bytes(cp.rowptr) + 4 * cp.n_cols
          + 4 * cp.n_rows, 2 * c.nnz, c.nnz, c.n_rows,
          (cp.vals, cp.cols, cp.rowptr), "fd pagerank, plus_times")

    # segmented CSR: y = base ⊕ (heavy stream ⊗ x); x, the base and y
    plan = plans[("rmat", "pagerank")]
    hp, hyb = plan.prep.heavy, plan.container
    x = torch.rand(hp.n_cols, generator=gen).to(dev)
    base = torch.rand(hp.n_rows, generator=gen).to(dev)
    A = sparse_csr(hyb.hrows, hyb.hcols, hyb.hvals, hyb.n_rows, hyb.n_cols)
    args = (hp, x, pt)
    entry("spmv_csr_seg", lambda: K.spmv_csr_seg(*args, base=base),
          lambda: K.spmv_csr_seg_plain(*args, base=base), lambda: A @ x,
          8 * hyb.heavy_nnz + 4 * hp.n_cols + 8 * hp.n_rows,
          2 * hyb.heavy_nnz + hp.n_rows, hyb.heavy_nnz, hp.n_rows,
          (hp.vals, hp.cols, hp.rid, hp.order, hp.merge_ptr, hp.merge_idx,
           hp.long_rows),
          "rmat pagerank heavy stream, plus_times")
    return out


def _coo(csr):
    rows = torch.repeat_interleave(
        torch.arange(csr.n_rows, device=csr.data.device),
        torch.diff(csr.indptr.long()))
    return rows, csr.indices, csr.data


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=22,
                    help="rows of the main path's matrices (2^k)")
    ap.add_argument("--dia-log2n", type=int, default=16,
                    help="rows of the DIA path's FD matrix (<= 16)")
    ap.add_argument("--reps", type=int, default=50,
                    help="kernel launches per timing")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the phases on the CPU's plain versions at a "
                         "small size; prints no result")
    args = ap.parse_args(argv)
    if args.cpu_rehearsal:
        dev = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    else:
        dev = torch.device("cuda", torch.cuda.current_device())
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import kernels as K
        from repro_torch.core.generators import fd_matrix, rmat_matrix
        from repro_torch.graph import drivers
        from repro_torch.graph.semiring import SEMIRINGS as SR
        from repro_torch.kernels import _build
        from repro_torch.plan import PlanCache, compile as compile_plan
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    # -- device --------------------------------------------------------------
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, "nvidia-smi failed")
        for line in smi.stdout.strip().splitlines():
            log(line.strip())           # name, power limit
        build_s = _build.build_all()
        log(f"device torch {torch.__version__} cuda {torch.version.cuda} "
            f"kind={torch.cuda.get_device_name(0)} "
            f"count={torch.cuda.device_count()} nvcc_build_s={build_s:.2f}")
        # one launch of each kernel on a tiny matrix; with the small phase
        # below (every driver, so every PyTorch kernel and library the
        # steppers use), this keeps one-time loading out of the main
        # path's iterations
        tiny = rmat_matrix(256, device=dev)
        for fmt in ("dia", "ell", "csr", "hyb"):
            compile_plan(tiny, format=fmt, device=dev).execute(
                torch.ones(256, device=dev))
    else:
        log("device cpu rehearsal: plain versions only, no kernels")

    # -- small inputs against the CPU path --------------------------------------
    for fam, gen in (("fd", fd_matrix), ("rmat", rmat_matrix)):
        here = drive(drivers, fam, gen(1024, device=dev), None, dev, True)
        cpu = drive(drivers, fam, gen(1024, device="cpu"), None,
                    torch.device("cpu"), True)
        compare_runs(f"small {fam} 2^10 vs cpu", here, cpu)
    sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    # -- main path ------------------------------------------------------------
    n = 1 << args.log2n
    t0 = time.perf_counter()
    adjs = {"fd": fd_matrix(n, device=dev), "rmat": rmat_matrix(n, device=dev)}
    log(f"main generate 2^{args.log2n}: fd nnz={adjs['fd'].nnz} "
        f"rmat nnz={adjs['rmat'].nnz} gen_s={time.perf_counter() - t0:.2f}")
    cache = PlanCache(max_plans=64)
    K.reset_launch_counts()
    kern = {fam: drive(drivers, fam, adj, cache, dev, True)
            for fam, adj in adjs.items()}
    counts = K.launch_counts()
    log(f"main launches {json.dumps(counts)}")
    for fam in adjs:
        for name in ANALYTICS:
            res = kern[fam][name][0]
            report_run("main", fam, name, *kern[fam][name],
                       cap=FD_CAP if fam == "fd" and name != "pagerank"
                       else None, spmv=spmv_ms(res.plan, dev))
    if dev.type == "cuda":
        for k in ("spmv_ell", "spmv_csr", "spmv_csr_seg"):
            check(counts[k] > 0, f"main path launched {k} no time")
    plain = {fam: drive(drivers, fam, adj, cache, dev, False)
             for fam, adj in adjs.items()}
    for fam in adjs:
        for name in ANALYTICS:
            report_run("plain", fam, name, *plain[fam][name])
        compare_runs(f"main {fam}", kern[fam], plain[fam])
    iters = {k: 0 for k in counts}
    for fam in adjs:
        for name in ANALYTICS:
            res = kern[fam][name][0]
            fmt = res.plan.format_name
            for k in {"csr": ["spmv_csr"], "ell": ["spmv_ell"],
                      "dia": ["spmv_dia"],
                      "hyb": ["spmv_ell", "spmv_csr_seg"]}[fmt]:
                iters[k] += res.n_iters

    # -- DIA path -------------------------------------------------------------
    nd = 1 << args.dia_log2n
    fd_small = fd_matrix(nd, device=dev)
    r0 = np.random.default_rng(7).uniform(0.5, 1.5, nd).astype(np.float32)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    dres = drivers.pagerank(fd_small, tol=PR_TOL, r0=r0, plan_cache=cache,
                            device=dev)
    sync(dev)
    dwall = time.perf_counter() - t0
    dia_counts = K.launch_counts()
    report_run("dia", "fd", "pagerank", dres, dwall,
               spmv=spmv_ms(dres.plan, dev))
    log(f"dia launches {json.dumps(dia_counts)}")
    check(dres.plan.format_name == "dia",
          f"FD 2^{args.dia_log2n} PageRank compiled to "
          f"{dres.plan.format_name}, not dia")
    if dev.type == "cuda":
        check(dia_counts["spmv_dia"] > 0, "DIA path launched spmv_dia no time")
    dplain = drivers.pagerank(fd_small, tol=PR_TOL, r0=r0, plan_cache=cache,
                              use_pallas=False, device=dev)
    check(dplain.n_iters == dres.n_iters, "dia pagerank: iteration counts "
          f"{dres.n_iters} vs {dplain.n_iters}")
    log(f"dia pagerank kernels vs plain: iters {dres.n_iters} == "
        f"{dplain.n_iters}")
    compare_pagerank("dia", dres, dplain)
    counts["spmv_dia"] = dia_counts["spmv_dia"]
    iters["spmv_dia"] = dres.n_iters

    # -- kernel vs plain -------------------------------------------------------
    plans = {(fam, name): kern[fam][name][0].plan
             for fam in adjs for name in ANALYTICS}
    plans[("dia", "pagerank")] = dres.plan
    want = {("fd", "pagerank"): "csr", ("dia", "pagerank"): "dia"}
    want.update({("fd", a): "ell" for a in ANALYTICS[1:]})
    want.update({("rmat", a): "hyb" for a in ANALYTICS})
    got = {k: p.format_name for k, p in plans.items()}
    if not check(got == want, f"formats {got} are not the main path's "
                 f"{want}; the kernel phases need those layouts"):
        return 1
    errs = kernel_vs_plain(K, SR, plans, dev)

    # -- timing ------------------------------------------------------------------
    times = timings(K, SR, plans, dev, args.reps)
    if dev.type == "cuda":
        log(f"time peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    log(f"time total_s={time.perf_counter() - t_start:.1f}")

    kernels = []
    for name in K.KERNELS:
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": TPU_KERNELS[name], "launches": counts[name],
            "max_abs_err": errs.get(name, 0.0), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
        log(f"kernels {name}: launches={counts[name]} over "
            f"{iters[name]} iterations")
    if dev.type != "cuda":
        log(f"rehearsal done, {len(FAILURES)} failure(s); no result on CPU")
        return 3
    if FAILURES:
        log(f"{len(FAILURES)} check(s) failed")
        return 1
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
