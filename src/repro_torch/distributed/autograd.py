"""Differentiable collectives: `torch.autograd.Function`s over the
exchanges of `distributed.api`, each with its conjugate backward.  The
partitioned step (`distributed.partition`) is built from them.

  all_gather(x, axis, dim)  forward: the members' blocks concatenated
                            along `dim` in mesh order; backward: a
                            reduce-scatter, member j keeping the j-th
                            chunk of the sum of the members' gradients
                            (FSDP's gather of a weight's `data` blocks)
  psum(x, axes)             forward: the sum over the axes' members;
                            backward: the identity (Megatron's g, after a
                            row-parallel matmul)
  enter(x, axes)            forward: the identity; backward: the sum of
                            the members' gradients (Megatron's f, before
                            a column-parallel matmul)
  pmax(x, axes)             the maximum over the members, no gradient

`axes` is one axis name or a sequence of them, summed one after the
other in the order given.  Every sum is `api`'s: an all-gather, then
the blocks folded in mesh order, so every member gets the same bits (no
float atomics, no reduction order left to a library).  A Function acts
over the mesh bound when it runs forward (`api.bind_axes`, or a
`shard_map` body) and keeps that mesh for its backward.  `api.STATS`
and `api.observe_collectives` see every exchange, backward ones
included.
"""
from __future__ import annotations

import functools
from typing import Sequence, Union

import torch

from . import api

Axes = Union[str, Sequence[str]]


def _names(axes: Axes) -> tuple:
    """The axes of more than one member (a sum over one is the
    identity)."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(n for n in names
                 if api.mesh_dict(api._bound(n))[n] > 1)


def _sum(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    for name in axes:
        blocks = api._gather_blocks(x, mesh, name)
        api._observe("all-reduce", 2 * api._bytes(x), len(blocks))
        x = functools.reduce(torch.add, blocks)
    return x


def _mesh_of(axes: tuple):
    mesh = None
    for name in axes:
        mesh = api._bound(name)
    return mesh


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, name, dim):
        ctx.mesh, ctx.name, ctx.dim = mesh, name, dim
        blocks = api._gather_blocks(x, mesh, name)
        out = torch.cat(blocks, dim)
        api._observe("all-gather", api._bytes(out), len(blocks))
        return out

    @staticmethod
    def backward(ctx, g):
        return (api.reduce_scatter(g, ctx.mesh, ctx.name, ctx.dim),
                None, None, None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.mesh, ctx.axes), None, None


def all_gather(x: torch.Tensor, axis_name: str, dim: int = 0
               ) -> torch.Tensor:
    mesh = api._bound(axis_name)
    if api.mesh_dict(mesh)[axis_name] == 1:
        return x
    return _AllGather.apply(x, mesh, axis_name, dim)


def psum(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    names = _names(axes)
    if not names:
        return x
    return _Psum.apply(x, _mesh_of(names), names)


def enter(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    names = _names(axes)
    if not names:
        return x
    return _Enter.apply(x, _mesh_of(names), names)


def pmax(x: torch.Tensor, axes: Axes) -> torch.Tensor:
    x = x.detach()
    for name in _names(axes):
        x = api.pmax(x, name)
    return x
