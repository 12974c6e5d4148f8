#!/usr/bin/env python3
"""The JAX reference's `plan.compile` decisions on `chip_smoke.py`'s
2^22 matrices, which the smoke's `compile` phase holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/reference_decisions.py

Builds, with the reference package on the CPU, FD and R-MAT at 2^22 rows
and the smoke's scrambled band (`banded_matrix(2^22, 8)` under
`default_rng(0).permutation(2^22)` applied to rows and columns), runs
the default `repro.plan.compile` (reorder="auto", predictor="auto") on
each and `predictor="oracle"` on the band, and prints one JSON line per
compile: the chosen reordering, the format, the resolved scoring, each
candidate's predicted GFLOPS (as `float.hex`, exact) and its 19 model
features, and the compile's seconds.  `--log2n` runs another size.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _matrices(log2n):
    from repro.core.generators import banded_matrix, fd_matrix, rmat_matrix
    from repro.reorder import Reordering

    n = 1 << log2n
    perm = np.random.default_rng(0).permutation(n).astype(np.int64)
    scramble = Reordering(row_perm=perm, col_perm=perm, strategy="scramble",
                          params={}, stats={})
    return {"fd": lambda: fd_matrix(n), "rmat": lambda: rmat_matrix(n),
            "band": lambda: scramble.apply(banded_matrix(n, 8))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=22)
    ap.add_argument("--only", default="fd,rmat,band")
    args = ap.parse_args(argv)

    from repro import plan
    from repro.core import structure
    from repro.plan.costmodel import features_for

    runs = {"fd": ["auto"], "rmat": ["auto"], "band": ["auto", "oracle"]}
    makers = _matrices(args.log2n)
    for name in args.only.split(","):
        t0 = time.perf_counter()
        m = makers[name]()
        gen_s = time.perf_counter() - t0
        for predictor in runs[name]:
            t0 = time.perf_counter()
            p = plan.compile(m, predictor=predictor)
            compile_s = time.perf_counter() - t0
            feats = {}
            if predictor == "auto":
                for label, r in (("none", None), ("rcm", p.reordering)):
                    if label == p.chosen:
                        rep = p.report
                    elif r is None:
                        rep = structure.analyze(m)
                    else:
                        continue       # only the kept candidate's report
                    feats[label] = features_for(rep, 1).tolist()
            print(json.dumps({
                "matrix": name, "log2n": args.log2n, "nnz": m.nnz,
                "predictor": predictor, "chosen": p.chosen,
                "format": p.format_name,
                "scoring": p.compile_stats["scoring"],
                "gflops": {k: float(v["gflops"]).hex()
                           for k, v in sorted(p.predicted.items())},
                "gflops_dec": {k: v["gflops"]
                               for k, v in sorted(p.predicted.items())},
                "features": feats, "gen_s": round(gen_s, 2),
                "compile_s": round(compile_s, 2),
                "stats": {k: round(v, 4) for k, v in
                          p.compile_stats.items() if k.endswith("_s")}}),
                flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
