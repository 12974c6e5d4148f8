"""Mesh context, the sharding-constraint helper and `shard_map`: the
counterpart of `repro.distributed.api` (and of the `shard_map` that the
reference's mesh code takes from `repro.distributed.compat`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` whose dimension
names are the reference's axis names (`launch.mesh.make_mesh` builds
one over the ranks of a launched world).  The sharding rules also take
a plain ``{axis name: size}`` dict, so they evaluate at the production
shapes without that many ranks, as the reference's rules evaluate on an
abstract mesh.

Logical axes:
  dp     -> ("pod", "data") when the mesh has a pod axis, else ("data",)
  dpm    -> every axis of the mesh
  data   -> "data"
  model  -> "model"
  None   -> replicated (and so is an axis the mesh does not have)

`constrain`, which in the reference changes an array's placement and
never its values, is the identity with or without a mesh: outside the
partitioned step every rank holds the global activations, and inside it
(`distributed.partition`) each rank holds its `dp` block of them, which
it already holds where the reference constrains a value.

`shard_map(body, mesh, in_specs, out_specs)` runs `body` on each rank's
blocks: a spec is a `P` (the counterpart of `PartitionSpec`: one entry
per leading dimension, each an axis name, a tuple of names or None),
and a rank's block of an input is the block `NamedSharding` gives the
device at the same mesh coordinates (row-major over the named axes).
Each output is assembled by all-gathers along the axes its spec names;
an output whose spec is `P()` comes back as the body gave it.  Inside
`body` the collectives below act over one axis's ranks
(`mesh.get_group(axis)`), with `jax.lax`'s names and meanings.

How a collective moves a tensor is fixed by the axis group's backend,
not tried and retried: under NCCL every collective runs on the card's
tensors; under gloo (ranks that share a card, or the CPU) every
collective stages a CUDA tensor through host memory (`transport`).
Each is built on two exchanges, an all-gather and an all-to-all:
  psum, pmean, pmax  all-gather, then the members' blocks folded in
                     mesh order on every rank (the same bits on every
                     rank and in every replay)
  all_gather         all-gather
  all_to_all         all-to-all
  ppermute           all-to-all with one nonempty split a rank
  psum_scatter       all-to-all, then the received chunks added in
                     mesh order
`torch.distributed` carries no gradient, so `shard_map` refuses inputs
that require one: a differentiable `shard_map`, which the MoE mesh
paths need in order to train, is ROADMAP A11, slice 3g.  The dense
decoders train on a mesh through `distributed.autograd`'s collectives
instead (`distributed.partition`).

`bind_axes(mesh)` binds the collectives to a mesh's axes outside a
`shard_map` body: the partitioned step runs inside it on each rank's
blocks.

`STATS` counts the exchanges' calls and bytes sent, and their host wall
seconds with the staging copies (a host-staged exchange first waits for
the card, as its copy to the host would, so that wait is not counted).

`observe_collectives(fn)` has every collective over more than one member
call `fn(kind, wire_bytes)` with the reference's HLO name and ring-
algorithm wire bytes (`repro.roofline.hlo_costs`): psum and pmax an
"all-reduce" of 2x the operand's bytes, all_gather (and the assembly
of a shard_map output) an "all-gather" of the result's, psum_scatter a
"reduce-scatter" and all_to_all an "all-to-all" of the operand's,
ppermute a "collective-permute" of the result's.  The roofline's cost
counter (`roofline.op_costs`) listens so.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

_state = threading.local()

#: "calls", "bytes" (sent by this rank) and "seconds" of the exchanges
STATS: collections.Counter = collections.Counter()

MESH_TRAINING = ("a differentiable shard_map, for the MoE mesh paths "
                 "(ROADMAP A11, slice 3g): torch.distributed collectives "
                 "carry no gradient")


class P(tuple):
    """PartitionSpec: one entry per leading dimension -- an axis name, a
    tuple of names (blocks row-major over them) or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def mesh_dict(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh (or of such a dict itself)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def observe_collectives(fn: Callable[[str, int], None]):
    """A context in which every collective calls fn(kind, wire_bytes)
    (see the module docstring)."""
    @contextlib.contextmanager
    def scope():
        prev = getattr(_state, "observers", ())
        _state.observers = prev + (fn,)
        try:
            yield fn
        finally:
            _state.observers = prev
    return scope()


def _observe(kind: str, wire_bytes: int, members: int) -> None:
    if members > 1:
        for fn in getattr(_state, "observers", ()):
            fn(kind, wire_bytes)


def _bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def resolve_axis(mesh, logical: Optional[str]):
    names = tuple(mesh_dict(mesh))
    if logical is None:
        return None
    if logical == "dp":
        return ("pod", "data") if "pod" in names else ("data",)
    if logical == "dpm":   # every axis: fully shard one dim (e.g. batch
        return names       # for attention-free recurrences)
    if logical in names:
        return logical
    return None   # axis absent on this mesh -> replicate


def logical_spec(mesh, *logical_axes) -> P:
    return P(*[resolve_axis(mesh, a) for a in logical_axes])


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The identity: a sharding constraint moves no values.  Outside the
    partitioned step every rank holds the global activations; inside it
    the activations a rank holds are its `dp` rows, replicated over
    `model`, which is what the reference's constraints ask for."""
    return x


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

def _assemble(y: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The global output from every rank's block `y` under `spec`."""
    from .sharding import spec_axes
    for dim, entry in enumerate(spec):
        for name in reversed(spec_axes(entry)):   # the last axis is minor
            y = torch.cat(_gather_blocks(y, mesh, name), dim=dim)
            _observe("all-gather", _bytes(y), mesh_dict(mesh)[name])
    return y


def _map_specs(fn: Callable, tree, specs):
    """fn(leaf, spec) over a tree whose specs are one P for the whole
    (sub)tree or a tree of the same structure."""
    if isinstance(specs, P):
        from repro_torch.tree import tree_map
        return tree_map(lambda leaf: fn(leaf, specs), tree)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(specs, (list, tuple)):
        if len(specs) != len(tree):
            raise ValueError(f"shard_map: {len(specs)} specs for "
                             f"{len(tree)} values")
        out = [_map_specs(fn, t, s) for t, s in zip(tree, specs)]
        return tuple(out) if isinstance(tree, tuple) else out
    raise TypeError(f"shard_map: a spec must be a P or a tree of them, "
                    f"not {type(specs).__name__}")


def _refuse_grad(leaf):
    if isinstance(leaf, torch.Tensor) and leaf.requires_grad \
            and torch.is_grad_enabled():
        raise RuntimeError(f"shard_map: an input requires grad; "
                           f"{MESH_TRAINING}")
    return leaf


def shard_map(body: Callable, mesh, in_specs: Sequence, out_specs):
    """`jax.shard_map(body, mesh=mesh, in_specs=..., out_specs=...)` with
    `check_vma=False`: each rank runs `body` on its blocks of the global
    inputs; the outputs come back global (see the module docstring)."""
    from .sharding import block_of

    def run(*args):
        from repro_torch.tree import tree_map
        tree_map(_refuse_grad, args)
        blocks = _map_specs(lambda x, s: block_of(x, s, mesh), list(args),
                            list(in_specs))
        with bind_axes(mesh):
            out = body(*blocks)
        return _map_specs(lambda y, s: _assemble(y, s, mesh), out,
                          out_specs)
    return run


@contextlib.contextmanager
def bind_axes(mesh):
    """A context in which the collectives act over `mesh`'s axes, as in a
    `shard_map` body: each rank runs the code on the blocks it holds."""
    prev = getattr(_state, "shard", None)
    _state.shard = mesh
    try:
        yield mesh
    finally:
        _state.shard = prev


# ---------------------------------------------------------------------------
# Collectives inside a shard_map body
# ---------------------------------------------------------------------------

def _bound(axis_name: str):
    mesh = getattr(_state, "shard", None)
    if mesh is None or axis_name not in mesh_dict(mesh):
        raise NameError(f"unbound axis name: {axis_name!r} (collectives "
                        "run inside a shard_map body over its mesh's axes)")
    return mesh


def transport(mesh, axis_name: str) -> str:
    """"device" (NCCL: the collective reads the card's tensors) or
    "host" (gloo: a CUDA tensor is copied to host memory and back)."""
    backend = dist.get_backend(mesh.get_group(axis_name))
    return "device" if backend == "nccl" else "host"


def _wire(x: torch.Tensor, route: str) -> torch.Tensor:
    return (x.cpu() if route == "host" else x).contiguous()


def _start(x: torch.Tensor, route: str) -> float:
    if route == "host" and x.is_cuda:
        torch.cuda.synchronize(x.device)
    return time.perf_counter()


def _account(t0: float, sent: int) -> None:
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes"] += sent


def _gather_blocks(x: torch.Tensor, mesh, axis_name: str
                   ) -> List[torch.Tensor]:
    """Every member's `x`, in mesh order along `axis_name`."""
    n = mesh_dict(mesh)[axis_name]
    if n == 1:
        return [x]
    route = transport(mesh, axis_name)
    t0 = _start(x, route)
    src = _wire(x, route)
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=mesh.get_group(axis_name))
    blocks = [o.to(x.device) for o in out]
    _account(t0, src.numel() * src.element_size() * (n - 1))
    return blocks


def _exchange(x: torch.Tensor, mesh, axis_name: str, send: List[int],
              recv: List[int], out_shape) -> torch.Tensor:
    """all_to_all_single of the flat `x`: `send[j]` elements to member j,
    `recv[j]` from member j, in mesh order."""
    route = transport(mesh, axis_name)
    t0 = _start(x, route)
    src = _wire(x, route).reshape(-1)
    out = torch.empty(sum(recv), dtype=x.dtype, device=src.device)
    dist.all_to_all_single(out, src, output_split_sizes=recv,
                           input_split_sizes=send,
                           group=mesh.get_group(axis_name))
    out = out.to(x.device).reshape(out_shape)
    me = mesh.get_local_rank(axis_name)
    _account(t0, (sum(send) - send[me]) * src.element_size())
    return out


def axis_index(axis_name: str) -> int:
    return _bound(axis_name).get_local_rank(axis_name)


def axis_size(axis_name: str) -> int:
    return mesh_dict(_bound(axis_name))[axis_name]


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    blocks = _gather_blocks(x, _bound(axis_name), axis_name)
    _observe("all-reduce", 2 * _bytes(x), len(blocks))
    return functools.reduce(torch.add, blocks)


def pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    return psum(x, axis_name) / axis_size(axis_name)


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    blocks = _gather_blocks(x, _bound(axis_name), axis_name)
    _observe("all-reduce", 2 * _bytes(x), len(blocks))
    return functools.reduce(torch.maximum, blocks)


def all_gather(x: torch.Tensor, axis_name: str, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    blocks = _gather_blocks(x, _bound(axis_name), axis_name)
    _observe("all-gather", len(blocks) * _bytes(x), len(blocks))
    return torch.cat(blocks, axis) if tiled else torch.stack(blocks, axis)


def all_to_all(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """`jax.lax.all_to_all(x, axis_name, split_axis=0, concat_axis=0,
    tiled=False)`: x is (M, ...) over an axis of M members; row j goes to
    member j, and row j of the result came from member j."""
    mesh = _bound(axis_name)
    n = mesh_dict(mesh)[axis_name]
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: dim 0 is {x.shape[0]}, not the "
                         f"{n} members of {axis_name!r}")
    if n == 1:
        return x
    row = x[0].numel()
    _observe("all-to-all", _bytes(x), n)
    return _exchange(x, mesh, axis_name, [row] * n, [row] * n, x.shape)


def ppermute(x: torch.Tensor, axis_name: str, perm) -> torch.Tensor:
    """Member `src` sends x to member `dst` for each (src, dst) of
    `perm`; a member no one sends to gets zeros."""
    mesh = _bound(axis_name)
    n = mesh_dict(mesh)[axis_name]
    me = mesh.get_local_rank(axis_name)
    send = [0] * n
    recv = [0] * n
    for src, dst in perm:
        if src == me:
            send[dst] = x.numel()
        if dst == me:
            recv[src] = x.numel()
    if n == 1:
        return x if recv[0] else torch.zeros_like(x)
    _observe("collective-permute", _bytes(x), n)
    out = _exchange(x, mesh, axis_name, send, recv,
                    x.shape if any(recv) else (0,))
    return out if any(recv) else torch.zeros_like(x)


def psum_scatter(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """`jax.lax.psum_scatter(x, axis_name, scatter_dimension=0,
    tiled=True)`: member j keeps the j-th chunk of dim 0 of the sum."""
    return reduce_scatter(x, _bound(axis_name), axis_name)


def reduce_scatter(x: torch.Tensor, mesh, axis_name: str,
                   dim: int = 0) -> torch.Tensor:
    """Member j's j-th chunk along `dim` of the members' sum, the chunks
    received added in mesh order."""
    n = mesh_dict(mesh)[axis_name]
    if n == 1:
        return x
    _observe("reduce-scatter", _bytes(x), n)
    y = x.movedim(dim, 0).contiguous()
    chunk = y.numel() // n
    recv = _exchange(y, mesh, axis_name, [chunk] * n, [chunk] * n,
                     (n, y.shape[0] // n) + tuple(y.shape[1:]))
    return functools.reduce(torch.add, recv.unbind(0)).movedim(0, dim)
