"""Roofline report generator: dryrun.jsonl -> markdown tables and a
bottleneck diagnosis -- the counterpart of `repro.roofline.report`.

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        --in experiments/dryrun.jsonl --out experiments/roofline.md

The reference's tables (single pod, multi-pod) and diagnosis, and a
third table of the records on the one-rank mesh (`dryrun --local`).
"""
from __future__ import annotations

import argparse
import json

MOVE_HINTS = {
    # what would move the dominant term down, per (kind, bottleneck)
    ("train", "memory"): "shard activations over 'model' (sequence "
        "parallelism) and cut remat recompute of cheap ops",
    ("train", "collective"): "replace Megatron per-layer all-reduce with "
        "reduce-scatter+all-gather (SP); overlap FSDP gathers with compute",
    ("train", "compute"): "already bound by the tensor cores: raise "
        "per-chip batch or accept (near roofline)",
    ("prefill", "memory"): "fuse attention (flash) so scores never hit HBM; "
        "shard sequence over 'model'",
    ("prefill", "collective"): "sequence-parallel norms + qkv projections",
    ("decode", "memory"): "decode is KV-bandwidth-bound by nature; pack "
        "more concurrent sequences per chip or quantize KV to int8",
    ("decode", "collective"): "keep KV sequence-sharded and merge partial "
        "attention with LSE-psum instead of re-gathering the cache",
    ("decode", "compute"): "batch more sequences",
}


def fmt_bytes(b):
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def mesh_kind(r):
    """False (single pod), True (multi-pod) -- the reference's key -- or
    "local" for a record on one rank."""
    if r.get("n_chips") == 1:
        return "local"
    return "pod" in r["mesh"] and r["mesh"].get("pod", 1) > 1


def load(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    best = {}
    for r in recs:      # last record per cell wins (re-runs append)
        best[(r["arch"], r["shape"], mesh_kind(r))] = r
    return best


def table(recs, multi_pod=False):
    """The cells of one mesh kind: multi_pod False, True or "local"."""
    rows = []
    hdr = ("| arch | shape | kind | compute_s | memory_s | collective_s | "
           "bottleneck | useful-FLOP frac | roofline frac |")
    sep = "|" + "---|" * 9
    rows.append(hdr)
    rows.append(sep)
    for (arch, shape, mp), r in sorted(recs.items(), key=lambda kv: (
            kv[0][0], kv[0][1], str(kv[0][2]))):
        if mp != multi_pod:
            continue
        if r["status"] != "ok":
            rows.append(f"| {arch} | {shape} | {r['kind']} | ERROR: "
                        f"{r['error'][:60]} | | | | | |")
            continue
        dom = max(r["compute_s"], r["memory_s"], r["collective_s"])
        # roofline fraction: the compute term is the ideal-time floor;
        # fraction = compute_s / max(all terms) (1.0 = compute-bound at peak)
        frac = r["compute_s"] / dom if dom > 0 else 0.0
        rows.append(
            f"| {arch} | {shape} | {r['kind']} "
            f"| {r['compute_s']*1e3:9.2f}ms | {r['memory_s']*1e3:9.2f}ms "
            f"| {r['collective_s']*1e3:9.2f}ms | {r['bottleneck']} "
            f"| {r['useful_flops_frac']:.3f} | {frac:.4f} |")
    return "\n".join(rows)


def diagnosis(recs):
    out = []
    for (arch, shape, mp), r in sorted(recs.items(), key=lambda kv: (
            kv[0][0], kv[0][1], str(kv[0][2]))):
        if mp is True or r["status"] != "ok":
            continue
        hint = MOVE_HINTS.get((r["kind"], r["bottleneck"]), "n/a")
        colls = ", ".join(f"{k}={fmt_bytes(v)}" for k, v in
                          sorted(r.get("collectives", {}).items()))
        out.append(f"- **{arch} x {shape}**: {r['bottleneck']}-bound "
                   f"(compute {r['compute_s']*1e3:.1f}ms / memory "
                   f"{r['memory_s']*1e3:.1f}ms / collective "
                   f"{r['collective_s']*1e3:.1f}ms; {colls}). "
                   f"Move it down: {hint}.")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="experiments/dryrun.jsonl")
    ap.add_argument("--out", default="experiments/roofline.md")
    args = ap.parse_args(argv)
    recs = load(args.inp)
    parts = [
        "## Roofline (single-pod 16x16 = 256 chips)",
        "", table(recs, multi_pod=False), "",
        "## Multi-pod check (2x16x16 = 512 chips)",
        "", table(recs, multi_pod=True), "",
        "## One rank (data 1 x model 1: the step the port runs)",
        "", table(recs, multi_pod="local"), "",
        "## Per-cell bottleneck diagnosis (single-pod and one rank)",
        "", diagnosis(recs), "",
    ]
    text = "\n".join(parts)
    with open(args.out, "w") as f:
        f.write(text)
    print(text[:4000])
    print(f"... -> {args.out}")


if __name__ == "__main__":
    main()
