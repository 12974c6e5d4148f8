"""Re-derive roofline records from saved per-op traces with the CURRENT
analyzer -- the counterpart of `repro.roofline.reanalyze`: keeps
baseline and optimized numbers measured identically even when the
analyzer changes after a sweep ran.

    PYTHONPATH=src python -m repro_torch.roofline.reanalyze \\
        --jsonl experiments/dryrun.jsonl --trace-dir experiments/traces \\
        --out experiments/dryrun_reanalyzed.jsonl

A trace is the rows `launch.dryrun --save-trace` wrote
(`op_costs.ROW_FIELDS`); the reference re-parses saved HLO text.
"""
from __future__ import annotations

import argparse
import json
import os

from . import analysis
from .op_costs import costs_of_rows


def trace_path(rec: dict, trace_dir: str) -> str:
    from repro_torch.launch.dryrun import mesh_tag, trace_tag
    mesh = rec["mesh"]
    tag = mesh_tag(mesh.get("pod", 1) > 1, rec["n_chips"] == 1)
    return os.path.join(trace_dir, trace_tag(
        rec["arch"], rec["shape"], tag,
        rec.get("profile", "baseline")) + ".ops.jsonl")


def reanalyze_record(rec: dict, trace_dir: str) -> dict:
    if rec.get("status") != "ok":
        return rec
    path = trace_path(rec, trace_dir)
    if not os.path.exists(path):
        rec["reanalyzed"] = False
        return rec
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    rl = analysis.analyze(costs_of_rows(rows), n_chips=rec["n_chips"],
                          model_flops=rec.get("model_flops", 0.0))
    rec.update(
        flops_per_chip=rl.flops,
        hbm_bytes_per_chip=rl.hbm_bytes,
        collective_bytes_per_chip=rl.collective_bytes,
        collectives=rl.collectives,
        collective_counts=rl.collective_counts,
        compute_s=rl.compute_s, memory_s=rl.memory_s,
        collective_s=rl.collective_s, bottleneck=rl.bottleneck,
        useful_flops_frac=rl.useful_flops_frac,
        reanalyzed=True,
    )
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jsonl", default="experiments/dryrun.jsonl")
    ap.add_argument("--trace-dir", default="experiments/traces")
    ap.add_argument("--out", default="experiments/dryrun_reanalyzed.jsonl")
    args = ap.parse_args(argv)
    n = 0
    with open(args.out, "w") as out, open(args.jsonl) as inp:
        for line in inp:
            rec = reanalyze_record(json.loads(line), args.trace_dir)
            out.write(json.dumps(rec) + "\n")
            n += rec.get("reanalyzed", False)
    print(f"reanalyzed {n} records -> {args.out}")


if __name__ == "__main__":
    main()
