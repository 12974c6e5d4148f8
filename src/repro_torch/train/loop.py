"""Training step factory: loss -> grads -> optimizer, with microbatching
(the counterpart of `repro.train.loop`).

The train state is (params, opt_state) in the reference's layout
(`models.convert.params_to_reference`: layers stacked per period
position): the reference's optimizers treat a stacked leaf as one leaf
(weight decay by its dims, Adafactor's factoring and RMS clip over the
whole stack), and checkpoints then carry the reference's keys.  The
model reads per-layer views of the stacked tensors
(`params_from_reference`), so the step allocates no copy of them.

Gradients come from autograd over `loss_fn(..., use_kernels=False)`:
the plain attention, which the reference's training path runs; the
attention kernels have no backward.  With `accum_steps = a` the batch
splits as the reference's reshape (a, b // a, ...), float32 gradients
summed over the microbatches and divided by a.  The optimizer updates
the state's tensors in place, inside a profiler range named "optimizer"
(what a `torch.profiler` trace of a step attributes to it).

On a mesh of more than one rank (`make_train_step(mesh=)`, or the mesh
of `use_mesh`) the step is the partitioned one
(`distributed.partition`): it takes each rank's blocks of the state and
its `dp` rows of the batch, computes the global loss and gradient norm
on every rank and updates the blocks.  On one rank it is the step above.
With microbatches, microbatch i is every `dp` rank's i-th slice of its
rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch
from torch.profiler import record_function

from repro_torch.distributed.api import bind_axes, current_mesh
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.models.registry import ModelAPI
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.optim.adamw import global_norm
from repro_torch.tree import leaves, tree_map, unflatten

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    remat: str = "full"           # none | dots | full
    accum_steps: int = 1          # microbatch count (grad accumulation)
    log_every: int = 10
    checkpoint_every: int = 500
    n_steps: int = 100


def loss_and_grads(api: ModelAPI, remat: str = "full", part=None
                   ) -> Callable[[Params, Dict[str, torch.Tensor]],
                                 Tuple[torch.Tensor, Params]]:
    """(params, batch) -> (loss, grads): grads a tree like params, in the
    parameters' dtypes.  `part` (a `partition.RankLayout`): params are
    the rank's blocks and grads their gradients, summed over the mesh;
    the collectives act over `part.mesh`."""
    def value_and_grad(params, batch):
        axes = bind_axes(part.mesh) if part is not None \
            else contextlib.nullcontext()
        with torch.enable_grad(), axes:
            live = tree_map(lambda t: t.detach().requires_grad_(), params)
            dev = leaves(params)[0].device
            kw = {} if part is None else {"part": part}
            loss = api.loss_fn(params_from_reference(live, api.cfg, dev),
                               batch, remat=remat, use_kernels=False, **kw)
            # a parameter the loss does not use (a VLM's token embedding,
            # fed embeddings) gets a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, leaves(live),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), unflatten(params, grads)
    return value_and_grad


def make_train_step(api: ModelAPI, tc: TrainConfig, mesh=None
                    ) -> Callable[[Params, Any, Dict[str, torch.Tensor]],
                                  Tuple[Params, Any, Dict[str, Any]]]:
    """The step; on a mesh of more than one rank (`mesh`, else the mesh
    of `use_mesh`) the partitioned step on each rank's blocks."""
    from repro_torch.distributed import partition

    mesh = mesh if mesh is not None else current_mesh()
    part = partition.RankLayout(api.cfg, mesh) \
        if partition.is_partitioned(mesh) else None
    _, opt_update = make_optimizer(
        tc.optimizer, global_norm if part is None else part.global_norm)
    value_and_grad = loss_and_grads(api, tc.remat, part)
    axes = (lambda: bind_axes(part.mesh)) if part is not None \
        else contextlib.nullcontext

    def train_step(params, opt_state, batch):
        with axes():
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        if tc.accum_steps <= 1:
            loss, grads = value_and_grad(params, batch)
        else:
            a = tc.accum_steps
            mbs = {k: x.reshape((a, x.shape[0] // a) + x.shape[1:])
                   for k, x in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(a):
                mb_loss, mb_grads = value_and_grad(
                    params, {k: x[i] for k, x in mbs.items()})
                for acc, g in zip(leaves(grads), leaves(mb_grads)):
                    acc.add_(g.float())
                loss = loss + mb_loss
            loss = loss / a
            grads = tree_map(lambda g: g / a, grads)

        with record_function("optimizer"):
            new_params, new_opt_state, metrics = opt_update(
                grads, opt_state, params)
        metrics = dict(metrics, loss=loss)
        return new_params, new_opt_state, metrics

    return train_step


def init_train_state(api: ModelAPI, tc: TrainConfig, gen=None, device=None
                     ) -> Tuple[Params, Any]:
    """Seeded parameters (`api.init(gen, device)`) in the reference's
    layout, and the optimizer's initial state."""
    params = params_to_reference(api.init(gen, device), api.cfg)
    opt_init, _ = make_optimizer(tc.optimizer)
    return params, opt_init(params)
