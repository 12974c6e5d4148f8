"""Meshes and the world they live in: the counterpart of
`repro.launch.mesh`, plus the launcher that starts a world of ranks.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model); the pod
axis is the slow boundary -- only (compressed) gradients cross it.

A mesh is a `DeviceMesh` over every rank of the world, numbered
row-major as `init_device_mesh` numbers them, with one process group a
mesh line and axis, each with the world's timeout (`TIMEOUT`), so a
collective that hangs fails within minutes.

`World(n, device)` starts a world: n spawned ranks, each in the process
group after `init_process_group`, running the functions `World.run`
sends them; `launch(fn, n, device)` is one run in a new world.  The
backend is chosen once, from the device, and printed:
  nccl  one rank a card (every rank has its own);
  gloo  ranks that share a card, or the CPU.
The ranks meet through a `FileStore` in a private temporary directory
(no TCP port, so concurrent worlds cannot collide).  If a rank raises,
dies or outlives the timeout, the world stops the others and the run
raises.
"""
from __future__ import annotations

import datetime
import math
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device
from repro_torch.distributed.api import mesh_dict  # noqa: F401

TIMEOUT = datetime.timedelta(minutes=5)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> DeviceMesh:
    """Every rank of the launched world as a mesh of `shape` named
    `axes`; every rank calls it, in the same order."""
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise ValueError(f"make_mesh: a {shape} mesh needs a world of {n} "
                         f"ranks; this one has {world}")
    ranks = torch.arange(n).reshape(shape)
    me = dist.get_rank()
    groups = []
    for dim in range(len(shape)):
        mine = None
        for line in ranks.movedim(dim, -1).reshape(-1, shape[dim]).tolist():
            g = dist.new_group(line, timeout=TIMEOUT)
            if me in line:
                mine = g
        groups.append(mine)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh.from_group(groups, device_type, mesh=ranks,
                                 mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != math.prod(shape):
        raise ValueError(
            f"make_production_mesh: the {shape} mesh {axes} needs a world "
            f"of {math.prod(shape)} ranks; this one has {world}.  The "
            "sharding rules evaluate at production shapes without one: "
            "pass them {axis: size}")
    return make_mesh(shape, axes)


def make_local_mesh(model: int = 1, device=None) -> DeviceMesh:
    """The world as it is, as a (data, model) mesh with `model` ranks on
    the model axis: a launched world (`World`, `launch`), else torchrun's
    (`WORLD_SIZE`, `RANK` and the rendezvous in the environment; the
    backend `world_plan`'s for `device`, each rank on its card), else a
    world of one rank (gloo, in-process store)."""
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ:
            n, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
            backend, devices = world_plan(n, device)
            if devices[rank].type == "cuda":
                torch.cuda.set_device(devices[rank])
            dist.init_process_group(backend, rank=rank, world_size=n,
                                    timeout=TIMEOUT)
        else:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=TIMEOUT)
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} ranks does not divide "
                         f"this world of {n} rank{'s' * (n != 1)}: start "
                         "a world whose size it divides (launch.mesh.World "
                         "or torchrun --nproc-per-node)")
    return make_mesh((n // model, model), ("data", "model"))


# ---------------------------------------------------------------------------
# The world launcher
# ---------------------------------------------------------------------------

def world_plan(n: int, device=None) -> Tuple[str, List[torch.device]]:
    """(backend, each rank's device) for n ranks on `device`'s kind
    (None = the card)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", [dev] * n
    count = torch.cuda.device_count()
    if count >= n:
        return "nccl", [torch.device("cuda", r) for r in range(n)]
    return "gloo", [torch.device("cuda", r % count) for r in range(n)]


def _rank_main(rank, n, backend, device, store_path, tasks, out):
    try:
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.zeros((), device=device)          # the CUDA context
        dist.init_process_group(backend, store=dist.FileStore(store_path, n),
                                rank=rank, world_size=n, timeout=TIMEOUT)
    except BaseException:       # reported to the launcher, which raises
        out.put((rank, False, traceback.format_exc()))
        raise
    try:
        for fn, args in iter(tasks.get, None):
            try:
                out.put((rank, True, fn(rank, *args)))
            except BaseException:
                out.put((rank, False, traceback.format_exc()))
                raise
    finally:
        dist.destroy_process_group()


class World:
    """n spawned ranks in one process group (`world_plan`'s backend and
    devices), each running the functions `run` sends it.  The ranks start
    at once (imports, CUDA context, process group) and wait for work, so
    a caller can start them well before it needs them."""

    def __init__(self, n: int, device=None):
        backend, devices = world_plan(n, device)
        shared = ", ".join(sorted({str(d) for d in devices}))
        print(f"mesh world: {n} ranks on {shared}, backend {backend}"
              + (" (collectives stage CUDA tensors through host memory)"
                 if backend == "gloo" and devices[0].type == "cuda"
                 else ""), flush=True)
        ctx = multiprocessing.get_context("spawn")
        self.n = n
        self._dir = tempfile.TemporaryDirectory()
        self._out = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, n, backend, devices[r], os.path.join(self._dir.name, "store"),
            self._tasks[r], self._out)) for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, fn: Callable, args: Tuple = (),
            timeout_s: float = TIMEOUT.total_seconds()) -> List[Any]:
        """`fn(rank, *args)` on every rank; -> the results, by rank.  `fn`
        is importable by name and returns picklable values.  If a rank
        raises, dies or outlives the timeout, the world is closed and
        this raises."""
        for q in self._tasks:
            q.put((fn, args))
        results: dict = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < self.n:
                try:
                    rank, ok, value = self._out.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if p.exitcode is not None and r not in results]
                    if dead:
                        raise RuntimeError(
                            f"mesh world: rank {dead[0]} died with exit "
                            f"code {self._procs[dead[0]].exitcode}") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"mesh world: {self.n - len(results)} of "
                            f"{self.n} ranks still running after "
                            f"{timeout_s:.0f} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"mesh world: rank {rank} failed:\n"
                                       f"{value}")
                results[rank] = value
        except BaseException:
            self.close(wait=False)
            raise
        return [results[r] for r in range(self.n)]

    def close(self, wait: bool = True) -> None:
        """Stop every rank: let idle ones leave, kill the others."""
        for p, q in zip(self._procs, self._tasks):
            if wait and p.is_alive():
                q.put(None)
        for p in self._procs:
            p.join(timeout=60 if wait else 0)
            if p.is_alive():
                p.kill()
                p.join()
        self._dir.cleanup()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(wait=exc[0] is None)


def launch(fn: Callable, n: int, device=None, args: Tuple = (),
           timeout_s: float = TIMEOUT.total_seconds()) -> List[Any]:
    """Run `fn(rank, *args)` on a new world of n ranks; -> their results,
    by rank."""
    with World(n, device) as world:
        return world.run(fn, args, timeout_s)
