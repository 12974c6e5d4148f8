"""Sharded, checkpointed, resumable sweep execution (counterpart of
`repro.telemetry.runner`).

  1. a deterministic, sorted cell enumeration (`mech_cells`,
     `scaling_cells`, `graph_cells` -> `SweepCell`), so checkpoint keys
     and shard assignment are stable across runs and axis orderings;
  2. sharded execution across spawned worker processes
     (`execute_cells(workers=N)`); each worker makes its own CUDA
     context and loads the built kernels, and `shared_workers(N)` keeps
     one pool for every call inside it, so a series of sweeps starts
     its workers once;
  3. incremental checkpoints of completed cells through
     `repro_torch.checkpoint.CheckpointManager` (`ckpt_dir=`), each
     point a canonical JSON payload -- the reference's bytes for the
     same point, so a checkpoint written by either package resumes in
     the other;
  4. resume: a re-run with the same `ckpt_dir` loads the completed cells
     and runs only the rest, and the merged grid is byte-identical to an
     uninterrupted run.

`SweepConfig.device` names where cells run ("cuda", "cuda:1", "cpu";
None: the card), by name so the config pickles into spawned workers,
which resolve it themselves.  `python -m repro_torch.telemetry.runner`
is the command-line entry point.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cache_model import SANDY_BRIDGE, MachineModel

from .events import EventCounters
from .hierarchy import HierarchySpec
from .topdown import TopdownStages, TopdownSummary

# ---------------------------------------------------------------------------
# Cells: the unit of sharding, checkpointing and resume
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, order=True)
class SweepCell:
    """One grid cell, by label; labels resolve against `SweepConfig`.
    `key()` is the checkpoint key, the reference's string."""

    sweep: str                # 'mech' | 'scaling' | 'graph' | 'label'
    kind: str                 # 'fd' | 'rmat' | (label: costmodel.LABEL_KINDS)
    log2n: int
    reorder: str = "none"
    format: str = ""          # graph: pinned container format ('' = auto)
    threads: int = 1
    partition: str = ""       # scaling: 'equal' | 'balanced' | 'merge'
    mechanism: str = ""       # mech: label into SweepConfig.mechanisms;
                              # label: costmodel.LABEL_SPECS geometry key
    analytic: str = ""        # graph: driver name

    def key(self) -> str:
        return "|".join([
            self.sweep, self.kind, str(self.log2n), self.reorder,
            self.format or "-", str(self.threads), self.partition or "-",
            self.mechanism or "-", self.analytic or "-"])


def sort_cells(cells: Sequence[SweepCell]) -> List[SweepCell]:
    """Canonical execution order: deduplicated and sorted."""
    return sorted(set(cells))


def mech_cells(log2ns: Sequence[int], kinds: Sequence[str],
               mechanisms: Sequence[str] | Mapping[str, object],
               threads_list: Sequence[int] = (1,),
               reorderings: Sequence[str] | Mapping[str, object] = ("none",),
               ) -> List[SweepCell]:
    """`run_sweep`'s grid (mechanism labels x the matrix axes)."""
    return sort_cells([
        SweepCell(sweep="mech", kind=k, log2n=int(n), reorder=r,
                  threads=int(t), mechanism=m)
        for k in kinds for n in log2ns for r in list(reorderings)
        for t in set(threads_list) for m in list(mechanisms)])


def scaling_cells(log2ns: Sequence[int], kinds: Sequence[str],
                  threads_list: Sequence[int],
                  partition: str = "equal",
                  reorderings: Sequence[str] | Mapping[str, object] = ("none",),
                  ) -> List[SweepCell]:
    """`scaling_sweep`'s grid (the thread axis)."""
    return sort_cells([
        SweepCell(sweep="scaling", kind=k, log2n=int(n), reorder=r,
                  threads=int(t), partition=partition)
        for k in kinds for n in log2ns for r in list(reorderings)
        for t in set(threads_list)])


def graph_cells(log2ns: Sequence[int], kinds: Sequence[str],
                analytics: Sequence[str],
                format: Optional[str] = None) -> List[SweepCell]:
    """`graph_sweep`'s grid (whole-analytic cells)."""
    return sort_cells([
        SweepCell(sweep="graph", kind=k, log2n=int(n), analytic=a,
                  format=format or "")
        for k in kinds for n in log2ns for a in analytics])


def device_name(device) -> Optional[str]:
    """A device as `SweepConfig.device` holds it: its name, or None (the
    card)."""
    return None if device is None else str(device)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Everything a worker needs to resolve and run a cell (picklable:
    strategies are module-level callables, specs frozen dataclasses, the
    device a name).  `None` mappings fall back to the sweep module's
    defaults."""

    machine: MachineModel = SANDY_BRIDGE
    sweeps: int = 2
    seed: int = 0
    mechanisms: Optional[Mapping[str, HierarchySpec]] = None
    reorderings: Optional[Mapping[str, object]] = None
    parallel_spec: Optional[object] = None    # repro_torch.parallel.ParallelSpec
    hier_spec: Optional[HierarchySpec] = None  # graph per-iteration replay
    max_iters: int = 64
    graph_format: Optional[str] = None
    device: Optional[str] = None               # None: the card


def run_cell(cell: SweepCell, cfg: SweepConfig):
    """Execute one cell (pure, deterministic).  Returns the sweep point."""
    return _timed_cell(cell, cfg)[0]


def _timed_cell(cell: SweepCell, cfg: SweepConfig) -> Tuple[object, Dict]:
    """(point, stage seconds): a graph cell's "driver_s" (the analytic's
    iterations on the device) and "replay_s" (the trace replay on the
    host); no stages for the other families."""
    from . import sweep as sw

    reorderings = (dict(cfg.reorderings) if cfg.reorderings is not None
                   else {"none": None})
    if cell.sweep == "mech":
        mechanisms = (dict(cfg.mechanisms) if cfg.mechanisms is not None
                      else sw.MECHANISMS)
        return sw.run_mech_cell(
            cell.kind, cell.log2n, cell.reorder,
            reorderings[cell.reorder], cell.threads, cell.mechanism,
            mechanisms[cell.mechanism], machine=cfg.machine,
            sweeps=cfg.sweeps, seed=cfg.seed, device=cfg.device), {}
    if cell.sweep == "scaling":
        return sw.run_scaling_cell(
            cell.kind, cell.log2n, cell.reorder,
            reorderings[cell.reorder], cell.partition, cell.threads,
            spec=cfg.parallel_spec, machine=cfg.machine,
            sweeps=cfg.sweeps, seed=cfg.seed, device=cfg.device), {}
    if cell.sweep == "graph":
        t0 = time.perf_counter()
        res = sw.run_graph_analytic(
            cell.kind, cell.log2n, cell.analytic, seed=cfg.seed,
            max_iters=cfg.max_iters,
            format=cell.format or cfg.graph_format or None,
            device=cfg.device)
        t1 = time.perf_counter()
        point = sw.graph_point(cell.kind, cell.log2n, cell.analytic, res,
                               spec=cfg.hier_spec, machine=cfg.machine)
        return point, {"driver_s": t1 - t0,
                       "replay_s": time.perf_counter() - t1}
    if cell.sweep == "label":
        # cost-model training rows (the spec geometry rides `mechanism`)
        from repro_torch.plan import costmodel

        return costmodel.run_label_cell(
            cell.kind, cell.log2n, cell.reorder, cell.threads,
            spec_label=cell.mechanism, machine=cfg.machine,
            seed=cfg.seed, sweeps=cfg.sweeps, device=cfg.device), {}
    raise ValueError(f"unknown sweep family {cell.sweep!r}")


# ---------------------------------------------------------------------------
# Point payloads: canonical JSON, exact round-trip
# ---------------------------------------------------------------------------
# json writes Python floats in their shortest exact form, so
# decode(encode(p)) == p field for field, and the bytes are the
# reference's for the same point.


def _plain(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.bool_,)):
        return bool(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"cannot serialize {type(o)!r}")


def encode_point(p) -> bytes:
    """Canonical JSON payload for a sweep point (sorted keys, utf-8)."""
    from repro_torch.plan.costmodel import LabelPoint

    from .sweep import GraphPoint, ScalingPoint, SweepPoint

    if isinstance(p, LabelPoint):
        tag, d = "label", dataclasses.asdict(p)
    elif isinstance(p, SweepPoint):
        tag, d = "mech", {
            "kind": p.kind, "log2n": p.log2n, "nnz": p.nnz,
            "threads": p.threads, "mechanism": p.mechanism,
            "reorder": p.reorder, "spec": dataclasses.asdict(p.spec),
            "counters": p.counters.as_dict(),
            "summary": p.summary.as_dict()}
    elif isinstance(p, ScalingPoint):
        tag, d = "scaling", {
            "kind": p.kind, "log2n": p.log2n, "nnz": p.nnz,
            "threads": p.threads, "reorder": p.reorder,
            "partition": p.partition, "imbalance": p.imbalance,
            "speedup": p.speedup, "efficiency": p.efficiency,
            "metrics": dataclasses.asdict(p.metrics)}
    elif isinstance(p, GraphPoint):
        tag, d = "graph", {
            "kind": p.kind, "log2n": p.log2n, "nnz": p.nnz,
            "analytic": p.analytic, "semiring": p.semiring,
            "n_iters": p.n_iters, "converged": p.converged,
            "format_name": p.format_name,
            "iters": [s.as_dict() for s in p.iters]}
    else:
        raise TypeError(f"cannot encode {type(p)!r}")
    return json.dumps({"t": tag, "d": d}, sort_keys=True,
                      default=_plain).encode("utf-8")


def decode_point(blob: bytes):
    """Inverse of `encode_point` (value-exact)."""
    from repro_torch.parallel.scaling import ParallelMetrics

    from .sweep import GraphPoint, ScalingPoint, SweepPoint

    obj = json.loads(blob.decode("utf-8"))
    tag, d = obj["t"], obj["d"]
    if tag == "label":
        from repro_torch.plan.costmodel import LabelPoint

        return LabelPoint(
            kind=d["kind"], log2n=int(d["log2n"]), seed=int(d["seed"]),
            reorder=d["reorder"], threads=int(d["threads"]),
            spec=d["spec"], nnz=int(d["nnz"]), gflops=float(d["gflops"]),
            time_s=float(d["time_s"]),
            features=tuple(float(v) for v in d["features"]))
    if tag == "mech":
        return SweepPoint(
            kind=d["kind"], log2n=int(d["log2n"]), nnz=int(d["nnz"]),
            threads=int(d["threads"]), mechanism=d["mechanism"],
            reorder=d["reorder"], spec=HierarchySpec(**d["spec"]),
            counters=EventCounters({k: int(v)
                                    for k, v in d["counters"].items()}),
            summary=TopdownSummary(**d["summary"]))
    if tag == "scaling":
        m = dict(d["metrics"])
        m["nnz_per_thread"] = tuple(int(v) for v in m["nnz_per_thread"])
        m["cycles_per_thread"] = tuple(float(v)
                                       for v in m["cycles_per_thread"])
        m["l2_mpki"] = tuple(float(v) for v in m["l2_mpki"])
        m["llc_mpki"] = tuple(float(v) for v in m["llc_mpki"])
        m["stages"] = TopdownStages(**m["stages"])
        m["thread_stages"] = tuple(TopdownStages(**s)
                                   for s in m["thread_stages"])
        return ScalingPoint(
            kind=d["kind"], log2n=int(d["log2n"]), nnz=int(d["nnz"]),
            threads=int(d["threads"]), reorder=d["reorder"],
            partition=d["partition"], imbalance=float(d["imbalance"]),
            speedup=float(d["speedup"]), efficiency=float(d["efficiency"]),
            metrics=ParallelMetrics(**m))
    if tag == "graph":
        return GraphPoint(
            kind=d["kind"], log2n=int(d["log2n"]), nnz=int(d["nnz"]),
            analytic=d["analytic"], semiring=d["semiring"],
            n_iters=int(d["n_iters"]), converged=bool(d["converged"]),
            format_name=d["format_name"],
            iters=tuple(TopdownSummary(**s) for s in d["iters"]))
    raise ValueError(f"unknown payload tag {tag!r}")


# ---------------------------------------------------------------------------
# Execution: serial or sharded, with incremental checkpoint + resume
# ---------------------------------------------------------------------------


def _manager(ckpt_dir: str):
    from repro_torch.checkpoint import CheckpointManager

    return CheckpointManager(ckpt_dir, keep=2)


def _load_completed(mgr) -> Dict[str, bytes]:
    """key -> payload from the newest committed checkpoint (empty if none)."""
    try:
        tree, _ = mgr.restore_any()
    except FileNotFoundError:
        return {}
    cells = tree.get("cells", {})
    return {k: np.asarray(v, dtype=np.uint8).tobytes()
            for k, v in cells.items()}


def _save(mgr, done: Mapping[str, bytes]) -> None:
    """Checkpoint the completed-cell map; step = cell count."""
    tree = {"cells": {k: np.frombuffer(v, dtype=np.uint8)
                      for k, v in done.items()}}
    mgr.save(len(done), tree)


def _run_one(cell: SweepCell, cfg: SweepConfig) -> Tuple[str, bytes, Dict]:
    """(key, payload, info): info holds the cell's seconds, the kernel
    launches it made in this process, and a graph cell's stage seconds."""
    from repro_torch import kernels

    before = kernels.launch_counts()
    t0 = time.perf_counter()
    point, stages = _timed_cell(cell, cfg)
    blob = encode_point(point)
    info = {"seconds": time.perf_counter() - t0, **stages}
    after = kernels.launch_counts()
    info["launches"] = {k: after[k] - before[k] for k in after}
    return cell.key(), blob, info


def _run_chunk(chunk: List[SweepCell],
               cfg: SweepConfig) -> List[Tuple[str, bytes, Dict]]:
    """Worker entry: run a contiguous chunk."""
    return [_run_one(cell, cfg) for cell in chunk]


# (workers, pool) kept open by `shared_workers`
_SHARED: Dict[str, Tuple[int, ProcessPoolExecutor]] = {}


@contextlib.contextmanager
def shared_workers(workers: int):
    """One pool of `workers` spawned processes for every
    `execute_cells(workers=workers)` call in the block."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        _SHARED["pool"] = (workers, pool)
        try:
            yield pool
        finally:
            _SHARED.pop("pool", None)


def _run_sharded(pool, todo, workers, cfg, done, info, mgr) -> None:
    futs = [pool.submit(_run_chunk, chunk, cfg)
            for chunk in _chunks(todo, workers)]
    for fut in as_completed(futs):
        for key, blob, cinfo in fut.result():
            done[key], info[key] = blob, cinfo
        if mgr is not None:
            _save(mgr, done)


def _chunks(todo: List[SweepCell], workers: int) -> List[List[SweepCell]]:
    """Contiguous slices of the sorted order (so a chunk stays on one
    plan), at least ~4 chunks per worker for checkpoint granularity."""
    if not todo:
        return []
    per = max(1, math.ceil(len(todo) / (workers * 4)))
    return [todo[i:i + per] for i in range(0, len(todo), per)]


def execute_cells(cells: Sequence[SweepCell],
                  cfg: Optional[SweepConfig] = None,
                  workers: int = 1,
                  ckpt_dir: Optional[str] = None,
                  resume: bool = True,
                  checkpoint_every: int = 8,
                  max_cells: Optional[int] = None,
                  cell_info: Optional[Dict[str, Dict]] = None) -> List:
    """Run a cell list to completion and return its points in canonical
    (sorted, deduplicated) cell order.

    `workers > 1` shards the remaining cells across spawned worker
    processes (the pool of an open `shared_workers(workers)` block, or
    one of its own); `ckpt_dir` checkpoints completed cells (every
    `checkpoint_every` serial cells, after every parallel chunk) and,
    with `resume=True`, skips the cells already committed there.
    `max_cells` stops after that many new cells, returning only the
    points completed so far.  `cell_info`, a dict, receives for each
    cell this call ran its key -> {"seconds", "launches" (the kernel
    launches it made, in whichever process ran it), and a graph cell's
    "driver_s" / "replay_s"}.  The points are the same whatever the
    workers, interruptions or axis order.
    """
    cfg = cfg if cfg is not None else SweepConfig()
    cells = sort_cells(cells)
    mgr = _manager(ckpt_dir) if ckpt_dir else None
    done: Dict[str, bytes] = \
        _load_completed(mgr) if (mgr is not None and resume) else {}
    known = {c.key() for c in cells}
    todo = [c for c in cells if c.key() not in done]
    if max_cells is not None:
        todo = todo[:max_cells]
    info = cell_info if cell_info is not None else {}

    if workers <= 1 or len(todo) <= 1:
        fresh = 0
        for cell in todo:
            key, done[key], info[key] = _run_one(cell, cfg)
            fresh += 1
            if mgr is not None and fresh % max(checkpoint_every, 1) == 0:
                _save(mgr, done)
    elif _SHARED.get("pool", (0,))[0] == workers:
        _run_sharded(_SHARED["pool"][1], todo, workers, cfg, done, info, mgr)
    else:
        with shared_workers(workers) as pool:
            _run_sharded(pool, todo, workers, cfg, done, info, mgr)

    if mgr is not None:
        if todo:
            _save(mgr, done)
        mgr.wait()
    return [decode_point(done[c.key()]) for c in cells if c.key() in done
            and c.key() in known]


# ---------------------------------------------------------------------------
# CLI: `python -m repro_torch.telemetry.runner`
# ---------------------------------------------------------------------------


def _int_list(s: str) -> List[int]:
    return [int(v) for v in s.split(",") if v]


def _str_list(s: str) -> List[str]:
    return [v for v in s.split(",") if v]


def build_cells(args) -> Tuple[List[SweepCell], SweepConfig]:
    """Translate CLI arguments into (cells, config)."""
    from repro_torch.parallel import ParallelSpec

    reorderings: Dict[str, object] = {}
    for label in _str_list(args.reorders):
        if label == "none":
            reorderings[label] = None
        else:
            from repro_torch.reorder import STRATEGIES

            reorderings[label] = STRATEGIES[label]
    pspec = (ParallelSpec(l2_bytes=16 * 1024, llc_bytes=64 * 1024)
             if args.scaled else ParallelSpec())
    kinds = _str_list(args.kinds)
    log2ns = _int_list(args.log2ns)
    threads = _int_list(args.threads)
    device = device_name(args.device)
    if args.sweep == "mech":
        from .sweep import MECHANISMS

        mechs = ({m: MECHANISMS[m] for m in _str_list(args.mechanisms)}
                 if args.mechanisms else dict(MECHANISMS))
        cells = mech_cells(log2ns, kinds, mechs, threads_list=threads,
                           reorderings=reorderings)
        cfg = SweepConfig(sweeps=args.sweeps, seed=args.seed,
                          mechanisms=mechs, reorderings=reorderings,
                          device=device)
    elif args.sweep == "graph":
        cells = graph_cells(log2ns, kinds,
                            analytics=_str_list(args.analytics))
        cfg = SweepConfig(seed=args.seed, device=device)
    else:
        cells = scaling_cells(log2ns, kinds, threads_list=threads,
                              partition=args.partition,
                              reorderings=reorderings)
        cfg = SweepConfig(sweeps=args.sweeps, seed=args.seed,
                          reorderings=reorderings, parallel_spec=pspec,
                          device=device)
    return cells, cfg


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="sharded resumable sweep runner "
                    "(see repro_torch.telemetry.sweep for the grids)")
    ap.add_argument("--sweep", choices=("mech", "scaling", "graph"),
                    default="scaling")
    ap.add_argument("--kinds", default="fd,rmat")
    ap.add_argument("--log2ns", default="8")
    ap.add_argument("--threads", default="1,2,4")
    ap.add_argument("--partition", default="balanced",
                    choices=("equal", "balanced", "merge"))
    ap.add_argument("--reorders", default="none")
    ap.add_argument("--mechanisms", default="",
                    help="comma list of MECHANISMS labels (mech sweep)")
    ap.add_argument("--analytics", default="pagerank,bfs")
    ap.add_argument("--sweeps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scaled", action="store_true",
                    help="shrunken caches (the 2^12 'scaled' cell geometry)")
    ap.add_argument("--device", default=None,
                    help="where cells run, e.g. cuda, cuda:1 or cpu "
                         "(default: the card)")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore any existing checkpoint in --ckpt")
    ap.add_argument("--max-cells", type=int, default=None,
                    help="stop after N new cells (simulated interruption)")
    ap.add_argument("--checkpoint-every", type=int, default=8)
    ap.add_argument("--csv", action="store_true", help="print the report")
    ap.add_argument("--verify", action="store_true",
                    help="recompute the grid serially in-process and demand "
                         "byte-identical payloads (exit 1 on mismatch)")
    args = ap.parse_args(argv)

    cells, cfg = build_cells(args)
    points = execute_cells(cells, cfg, workers=args.workers,
                           ckpt_dir=args.ckpt, resume=not args.no_resume,
                           checkpoint_every=args.checkpoint_every,
                           max_cells=args.max_cells)
    print(f"[runner] {args.sweep} sweep: {len(points)}/{len(cells)} cells "
          f"complete (workers={args.workers}, "
          f"ckpt={args.ckpt or 'none'})")
    if args.csv and points:
        from . import report

        render = {"mech": report.to_csv, "scaling": report.scaling_report,
                  "graph": report.graph_report}[args.sweep]
        print(render(points))
    if args.verify:
        if len(points) < len(cells):
            print("[runner] verify: grid incomplete, run again without "
                  "--max-cells first")
            return 1
        fresh = execute_cells(cells, cfg, workers=1, ckpt_dir=None)
        got = [encode_point(p) for p in points]
        want = [encode_point(p) for p in fresh]
        if got != want:
            bad = sum(1 for g, w in zip(got, want) if g != w)
            print(f"[runner] verify FAILED: {bad} cells differ from the "
                  f"serial recomputation")
            return 1
        print(f"[runner] verify OK: {len(points)} cells byte-identical to "
              f"serial recomputation")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
