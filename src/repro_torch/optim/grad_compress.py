"""Gradient compression for the slow (cross-pod) all-reduce axis: the
counterpart of `repro.optim.grad_compress`.

int8 error-feedback quantization: each pod quantizes its local gradient
to int8 with a per-tensor scale, all-reduces the int8 payload,
dequantizes, and feeds the quantization residual back into the next
step's gradient (error feedback keeps the scheme unbiased in the long
run; Karimireddy et al. 2019).

Applied only across 'pod': `crosspod_allreduce_compressed` runs inside a
`shard_map` body (`distributed.api`) over the mesh's pod axis.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.distributed.api import all_gather, axis_size, pmean
from repro_torch.tree import tree_map

Params = Any


class CompressionState(NamedTuple):
    residual: Params     # error-feedback memory, same structure as grads


def compress_init(grads_shape: Params) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_shape))


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Params, state: CompressionState
                   ) -> Tuple[Params, Params, CompressionState]:
    """-> (int8_payload, scales, new_state).  Residual folded in first."""
    def one(g, r):
        gf = g.float() + r
        q, s = quantize_int8(gf)
        return q, s, gf - dequantize_int8(q, s)

    out = tree_map(one, grads, state.residual)      # (q, s, r) leaves
    pick = lambda i: tree_map(lambda _, t: t[i], grads, out)  # noqa: E731
    return pick(0), pick(1), CompressionState(residual=pick(2))


def decompress_grads(payload: Params, scales: Params) -> Params:
    return tree_map(dequantize_int8, payload, scales)


def crosspod_allreduce_compressed(grads: Params, state: CompressionState,
                                  axis_name: str = "pod"
                                  ) -> Tuple[Params, CompressionState]:
    """Inside shard_map: quantize -> psum(int8 as int32) -> dequantize.

    int8 payloads are summed in int32 (no overflow for <= 2^23 pods) and
    the scales are averaged -- a standard approximation that keeps one
    collective.  The payloads cross the wire as int8 and are summed in
    int32 on arrival: the integers of the reference's psum of int32, a
    quarter of its bytes.
    """
    payload, scales, new_state = compress_grads(grads, state)
    summed = tree_map(lambda q: all_gather(q, axis_name)
                      .to(torch.int32).sum(0), payload)
    mean_scale = tree_map(lambda s: pmean(s, axis_name), scales)
    n = axis_size(axis_name)
    reduced = tree_map(lambda q, s: q.float() * s / n, summed, mean_scale)
    return reduced, new_state
