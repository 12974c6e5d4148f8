#!/usr/bin/env python3
"""The JAX reference's payloads for `chip_smoke.py`'s `sweep` grids,
which the smoke's `sweep` phase holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_sweep.py \
        [--workers 4] [--only headline,mechanisms,scaling,graph,graph-csr]

Runs each grid through `repro.telemetry.sweep` on the CPU and prints one
JSON line per grid: its cell count, the seconds it took and the sha256
of its `runner.encode_point` payloads concatenated in cell order (the
sorted order `execute_cells` returns); for the graph grids also each
cell's payload sha256 and its (format, n_iters, converged, nnz,
semiring), by `analytic|kind`, and for a PageRank cell its
per-iteration summaries as runs of [sha256 prefix, iterations]
(`iteration_runs`), so that a port whose PageRank stops at another
iteration (ROADMAP C3) is held to the iterations both ran.  The numbers inside the payloads
are the simulated Sandy Bridge machine's cycles, misses and iteration
counts, not any device's.  The grids are the reference benchmarks' own:

  headline    run_sweep(log2ns=(12, 14, 16)), FD and R-MAT, the baseline
              hierarchy (`benchmarks/telemetry_bench.py` headline)
  mechanisms  run_sweep(log2ns=(14,)) over the five §V `MECHANISMS`
  scaling     scaling_sweep(log2ns=(12,), threads 1, 2, 4, 8,
              partition="balanced")
  graph       graph_sweep(log2ns=(12,), pagerank / bfs / sssp,
              HierarchySpec(l2_bytes=16384, l3_bytes=65536),
              max_iters=128) (`benchmarks/graph_bench.py` full size)
  graph-csr   the same with format="csr"

With 4 workers on an 8-core x86-64 CPU the five grids took 83 s
(headline 17.6, mechanisms 11.4, scaling 5.8, graph 26.0, graph-csr
22.2).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import time

GRAPH_SPEC = {"l2_bytes": 16384, "l3_bytes": 65536}
GRAPH_ANALYTICS = ("pagerank", "bfs", "sssp")


def grids(workers: int):
    from repro.telemetry import sweep
    from repro.telemetry.hierarchy import HierarchySpec

    spec = HierarchySpec(**GRAPH_SPEC)
    return {
        "headline": lambda: sweep.run_sweep(
            log2ns=(12, 14, 16), mechanisms={"baseline": HierarchySpec()},
            workers=workers),
        "mechanisms": lambda: sweep.run_sweep(
            log2ns=(14,), mechanisms=sweep.MECHANISMS, workers=workers),
        "scaling": lambda: sweep.scaling_sweep(
            log2ns=(12,), threads_list=(1, 2, 4, 8), partition="balanced",
            workers=workers),
        "graph": lambda: sweep.graph_sweep(
            log2ns=(12,), analytics=GRAPH_ANALYTICS, spec=spec,
            max_iters=128, workers=workers),
        "graph-csr": lambda: sweep.graph_sweep(
            log2ns=(12,), analytics=GRAPH_ANALYTICS, spec=spec,
            max_iters=128, format="csr", workers=workers),
    }


def iteration_runs(point) -> list:
    """[[sha256[:16] of one iteration's summary, consecutive
    iterations with it], ...] of a graph point, iteration 1 first."""
    runs: list = []
    for s in point.iters:
        h = hashlib.sha256(json.dumps(s.as_dict(), sort_keys=True)
                           .encode()).hexdigest()[:16]
        if runs and runs[-1][0] == h:
            runs[-1][1] += 1
        else:
            runs.append([h, 1])
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--only",
                    default="headline,mechanisms,scaling,graph,graph-csr")
    args = ap.parse_args(argv)

    from repro.telemetry.runner import encode_point

    runs = grids(args.workers)
    for name in args.only.split(","):
        t0 = time.perf_counter()
        points = runs[name]()
        blob = b"".join(encode_point(p) for p in points)
        extra = {}
        if name.startswith("graph"):
            extra["by_cell"] = {
                f"{p.analytic}|{p.kind}": [
                    hashlib.sha256(encode_point(p)).hexdigest(),
                    p.format_name, p.n_iters, p.converged, p.nnz,
                    p.semiring] for p in points}
            extra["iteration_runs"] = {
                f"{p.analytic}|{p.kind}": iteration_runs(p)
                for p in points if p.analytic == "pagerank"}
        print(json.dumps({"grid": name, "cells": len(points),
                          "sha256": hashlib.sha256(blob).hexdigest(),
                          "seconds": round(time.perf_counter() - t0, 1),
                          **extra}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
