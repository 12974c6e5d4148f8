"""Pipeline parallelism (GPipe-style) over a mesh axis, as a shard_map
body: the counterpart of `repro.distributed.pipeline`.

Not used by the production meshes (scan-over-layers + FSDP + TP); kept
and tested at toy scale as the stage-over-`pod` variant, where
activations crossing the slow axis once per stage beat gradient
all-reduces crossing it every step.

Model: `n_stages` members of `axis_name`, each owning `layers/n_stages`
consecutive layers (stacked leading dim on its param shard).  A
microbatch enters stage 0, and each tick every stage processes one
microbatch and ppermutes its activation to the next stage.  With M
microbatches the schedule runs M + n_stages - 1 ticks (the classic
bubble); utilization = M / (M + S - 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .api import axis_index, ppermute


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    n_stages: int
    n_microbatches: int
    axis_name: str = "stage"

    @property
    def n_ticks(self) -> int:
        return self.n_microbatches + self.n_stages - 1

    @property
    def bubble_fraction(self) -> float:
        return (self.n_stages - 1) / self.n_ticks


def pipeline_apply(stage_fn: Callable, cfg: PipelineConfig,
                   stage_params, x_microbatches: torch.Tensor
                   ) -> torch.Tensor:
    """Run microbatches through the pipeline inside shard_map.

    stage_fn(params_slice, x) -> x : one stage's computation.
    stage_params: this member's parameter shard (layers of its stage).
    x_microbatches: (M, mb, ...) -- every stage receives the same input;
    only stage 0 consumes it.

    Returns (M, mb, ...) outputs, valid on the LAST stage (other stages
    return zeros -- the caller selects stage n-1's block).
    """
    axis = cfg.axis_name
    s = cfg.n_stages
    idx = axis_index(axis)
    m = cfg.n_microbatches
    mb_shape = x_microbatches.shape[1:]
    held = x_microbatches.new_zeros(mb_shape)
    outputs = torch.zeros_like(x_microbatches)
    for t in range(cfg.n_ticks):
        # stage 0 ingests microbatch t (if in range), others use held
        if idx == 0:
            x_in = (x_microbatches[min(t, m - 1)] if t < m
                    else x_microbatches.new_zeros(mb_shape))
        else:
            x_in = held
        y = stage_fn(stage_params, x_in)
        # last stage emits microbatch (t - (s-1)) at tick t
        out_slot = t - (s - 1)
        if idx == s - 1 and out_slot >= 0:
            outputs[min(out_slot, m - 1)] = y
        # rotate activations forward one stage
        held = ppermute(y, axis, perm=[(i, (i + 1) % s) for i in range(s)])
    return outputs


def make_pipelined_mlp(cfg: PipelineConfig, layer_widths,
                       gen: torch.Generator, device=None):
    """Toy stage model for tests: each stage holds layers/n_stages dense
    layers; returns (per-stage params stacked on axis 0, stage_fn)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    n_layers = len(layer_widths) - 1
    if n_layers % cfg.n_stages:
        raise ValueError(f"{n_layers} layers do not split into "
                         f"{cfg.n_stages} stages")
    per = n_layers // cfg.n_stages
    ws = [torch.randn(layer_widths[i], layer_widths[i + 1], generator=gen,
                      device=dev) / layer_widths[i] ** 0.5
          for i in range(n_layers)]
    # uniform widths required for stacking; tests use equal widths
    stacked = torch.stack(ws).reshape(cfg.n_stages, per, *ws[0].shape)

    def stage_fn(params_slice, x):
        for w in params_slice:
            x = torch.tanh(x @ w)
        return x

    return stacked, stage_fn


def reference_apply(stacked: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sequential oracle for the toy pipelined MLP."""
    s, per = stacked.shape[:2]
    y = x
    for i in range(s):
        for j in range(per):
            y = torch.tanh(y @ stacked[i, j])
    return y
