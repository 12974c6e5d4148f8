"""Dry-run: build every (arch x shape) step plan, count its costs from a
shape-only trace and write the roofline terms -- the counterpart of
`repro.launch.dryrun`.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --local \\
        --arch granite-8b --shape decode_32k [--out experiments/dryrun.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k [--multi-pod | --both-meshes]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--local]

Nothing is allocated at full size: the inputs are fake tensors and the
step runs once under `roofline.op_costs.CostCounter`
(`LoweredPlan.trace()`), on the CPU, never on the card.

`--local` runs each cell on the one-rank mesh {data: 1, model: 1},
where the trace is exactly the step the port runs.  On the production
meshes (16 x 16, or 2 x 16 x 16 with --multi-pod) a cell builds a
"fake" world of 256 or 512 ranks in this process (a `FakeProcessGroup`:
no peers, no traffic; a child process when this one is in a world
already), the mesh over it (`launch.mesh.make_mesh`), and traces rank
0's partitioned step (`distributed.partition`) on its blocks of the
inputs: per-rank FLOPs, bytes and the collectives' wire bytes, as the
reference reads them from XLA's per-device module.  The dense decoders
have a partitioned step; the other families' cells record the plan's
memory and end in NotImplementedError (ROADMAP A11, slice 3g).

The record keys are the reference's, with these differences:
  lower_s      the trace's seconds (the reference: lowering)
  compile_s    absent (no compiler)
  memory       argument_size_in_bytes and alias_size_in_bytes only
               (`LoweredPlan.memory`, under the reference's specs); the
               output, temp and generated-code sizes come from a
               compiler the port does not have.  The partitioned decode
               step holds a cache split by rows and KV heads, where the
               reference's specs split it by rows and sequence
  cost         the counted totals under XLA's cost_analysis names
               ("flops", "transcendentals", "bytes accessed") and
               "matmul flops"
  --trace-dir / --save-trace  the per-op rows as JSONL
               (`<arch>_<shape>_<sp|mp|local>[_<profile>].ops.jsonl`),
               what `roofline.reanalyze` re-derives records from; the
               reference saves HLO text (--hlo-dir / --save-hlo)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import multiprocessing
import os
import time
import traceback

from repro_torch.configs import CONFIGS, SHAPES, applicable_shapes, \
    get_config
from repro_torch.launch.steps import build_plan, optimizer_for
from repro_torch.roofline import analysis as roofline

LOCAL_MESH = {"data": 1, "model": 1}


def production_mesh(multi_pod: bool) -> dict:
    """The reference's production meshes as {axis: size}."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_tag(multi_pod: bool, local: bool) -> str:
    return "local" if local else ("mp" if multi_pod else "sp")


def tokens_per_step(shape) -> float:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch * 1.0        # decode: one token per sequence


def model_flops(cfg, shape) -> float:
    n_active = cfg.active_param_count()
    toks = tokens_per_step(shape)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_active * toks


def trace_tag(arch: str, shape_name: str, tag: str, profile: str) -> str:
    return (f"{arch}_{shape_name}_{tag}"
            + ("" if profile == "baseline" else f"_{profile}"))


@contextlib.contextmanager
def fake_world(mesh: dict):
    """A world of prod(mesh) ranks in this process, this one rank 0, over
    a "fake" process group (collectives move nothing), and the mesh over
    it; the group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh.values()))
    try:
        yield make_mesh(tuple(mesh.values()), tuple(mesh))
    finally:
        dist.destroy_process_group()


def _cell_child(conn, args):
    try:
        conn.send(_run_cell(*args))
    finally:
        conn.close()


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             trace_dir: str | None = None, save_trace: bool = False,
             profile: str = "baseline", local: bool = False) -> dict:
    import torch.distributed as dist

    args = (get_config(arch), arch, shape_name, multi_pod, trace_dir,
            save_trace, profile, local)
    if not local and dist.is_initialized():
        # the fake world needs the process's default group: a child's
        ctx = multiprocessing.get_context("spawn")
        parent, child = ctx.Pipe(duplex=False)
        proc = ctx.Process(target=_cell_child, args=(child, args))
        proc.start()
        child.close()
        try:
            return parent.recv()
        finally:
            proc.join()
    return _run_cell(*args)


def _run_cell(cfg, arch, shape_name, multi_pod, trace_dir, save_trace,
              profile, local) -> dict:
    from repro_torch.models import tuning
    tuning.set_profile(profile)

    shape = SHAPES[shape_name]
    mesh = LOCAL_MESH if local else production_mesh(multi_pod)
    n_chips = math.prod(mesh.values())

    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": dict(mesh), "n_chips": n_chips,
        "kind": shape.kind, "optimizer": optimizer_for(cfg).name,
        "profile": profile, "knobs": tuning.snapshot(),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    tag = mesh_tag(multi_pod, local)
    try:
        plan = build_plan(cfg, shape, mesh)
        mem = plan.memory(mesh)
        mf = model_flops(cfg, shape)
        rec.update(memory=mem, model_flops=mf)
        t0 = time.time()
        if n_chips > 1:
            from repro_torch.distributed.partition import \
                require_partitioned
            require_partitioned(cfg)
            with fake_world(mesh) as dmesh:
                counter = plan.trace(dmesh)
        else:
            counter = plan.trace()
        rec["lower_s"] = round(time.time() - t0, 2)
        costs = counter.costs()
        cost = {"flops": float(costs.flops),
                "transcendentals": float(costs.transcendental),
                "bytes accessed": float(costs.bytes),
                "matmul flops": float(costs.matmul_flops)}
        rl = roofline.analyze(costs, n_chips=n_chips, model_flops=mf)

        rec.update(
            status="ok",
            cost=cost,
            flops_per_chip=rl.flops,
            hbm_bytes_per_chip=rl.hbm_bytes,
            collective_bytes_per_chip=rl.collective_bytes,
            collectives=rl.collectives,
            collective_counts=rl.collective_counts,
            compute_s=rl.compute_s, memory_s=rl.memory_s,
            collective_s=rl.collective_s, bottleneck=rl.bottleneck,
            useful_flops_frac=rl.useful_flops_frac,
        )
        print(f"[dryrun] {arch} x {shape_name} x {tag}: "
              f"trace {rec['lower_s']}s")
        print(f"  memory: {mem}")
        print(f"  cost: flops={costs.flops:.3e} matmul "
              f"flops={costs.matmul_flops:.3e} bytes={costs.bytes:.3e}")
        print(f"  roofline: {rl.summary()}")
        if save_trace and trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, trace_tag(
                arch, shape_name, tag, profile) + ".ops.jsonl")
            with open(path, "w") as f:
                for row in counter.rows():
                    f.write(json.dumps(row) + "\n")
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} x {shape_name} FAILED: {rec['error']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(CONFIGS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--local", action="store_true",
                    help="the one-rank mesh {data: 1, model: 1}")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun.jsonl")
    ap.add_argument("--trace-dir", default="experiments/traces")
    ap.add_argument("--save-trace", action="store_true")
    ap.add_argument("--profile", default="baseline",
                    choices=["baseline", "optimized"])
    args = ap.parse_args(argv)

    meshes = [False] if args.local else (
        [False, True] if args.both_meshes or args.all
        else [args.multi_pod])
    cells = []
    if args.all:
        for arch, cfg in sorted(CONFIGS.items()):
            for shape_name in applicable_shapes(cfg):
                cells += [(arch, shape_name, mp) for mp in meshes]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    n_ok = 0
    with open(args.out, "a") as f:
        for arch, shape_name, mp in cells:
            rec = run_cell(arch, shape_name, mp, trace_dir=args.trace_dir,
                           save_trace=args.save_trace, profile=args.profile,
                           local=args.local)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            n_ok += rec["status"] == "ok"
    print(f"[dryrun] {n_ok}/{len(cells)} cells OK -> {args.out}")
    if n_ok < len(cells):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
