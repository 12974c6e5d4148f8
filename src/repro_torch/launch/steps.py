"""Step plans: the (train / prefill / decode) step for one (arch x
shape), its inputs and their shardings -- the counterpart of
`repro.launch.steps`, shared by the dry-run and the training launcher.

Every `build_*_plan` returns a `LoweredPlan`:
    fn            -- the step function
    in_specs      -- the inputs as fake tensors (`registry.fake_mode()`:
                     shapes and dtypes, no storage), in the reference's
                     layouts: parameters and caches stacked as the
                     reference stacks them
    in_shardings  -- a tree of `P` matching in_specs
    out_shardings -- a tree of `P` (or None where the reference leaves
                     the placement to its compiler)
    donate        -- argnums donated (params/opt-state/cache buffers):
                     the step updates them in place

The reference lowers a plan with `jax.jit` and compiles it; the port's
counterpart is `LoweredPlan.trace()`, which runs the step once on the
fake inputs under a cost counter (`roofline.op_costs`).  The trace runs
the plain path (`use_kernels=False`), so each kernel's function is
counted by its plain version's operations; it never touches the card.
`memory(mesh)` gives what the reference reads from
`memory_analysis()` and needs no compiler: each rank's bytes of the
inputs under their specs and of the donated ones.  `floor_bytes` bounds
one step's device-memory traffic from below, for a roofline share that
the plain path's counted bytes would flatter.

The mesh is a `DeviceMesh` or a plain {axis: size} dict, as the sharding
rules take it.  A plan's inputs are the global ones; on a `DeviceMesh`
of more than one rank, `trace(mesh)` traces this rank's part of the
step instead (`rank_step`): the partitioned step
(`distributed.partition`) on the rank's blocks of the inputs -- the
parameters' and optimizer state's under their specs, the batch's `dp`
rows, the cache's rows and the KV heads the rank's query heads read --
with the collectives it calls (the dense decoders; other families raise
NotImplementedError, ROADMAP A11, slice 3g).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import partition
from repro_torch.distributed import sharding as shard_rules
from repro_torch.distributed.api import P, bind_axes, mesh_dict
from repro_torch.distributed.sharding import spec_leaves
from repro_torch.models import registry, transformer
from repro_torch.models.convert import (cache_from_reference,
                                        cache_into_reference,
                                        cache_to_reference,
                                        params_from_reference,
                                        params_to_reference)
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.tree import leaves, tree_map
from repro_torch.train.loop import TrainConfig, make_train_step

# Arch -> optimizer: AdamW's 8 B/param fp32 moments do not fit for the
# >= 200B-param configs on 256 x 16 GiB chips; they use factored Adafactor
# (DESIGN.md §8 "giant-model memory honesty").
ADAFACTOR_THRESHOLD = 2.0e11


def optimizer_for(cfg: ModelConfig) -> OptimizerConfig:
    name = "adafactor" if cfg.param_count() > ADAFACTOR_THRESHOLD else "adamw"
    return OptimizerConfig(name=name)


def block_bytes(x: torch.Tensor, spec: P, mesh) -> int:
    """One rank's bytes of `x` under `spec`: each dim split into the
    product of its axes' sizes (rounded up, as a padded shard is)."""
    sizes = mesh_dict(mesh)
    n = x.element_size()
    for dim, d in enumerate(x.shape):
        entry = spec[dim] if dim < len(spec) else None
        k = math.prod(sizes[a] for a in shard_rules.spec_axes(entry))
        n *= -(-d // k)
    return n


@dataclasses.dataclass(frozen=True)
class LoweredPlan:
    kind: str
    fn: Callable
    in_specs: Tuple
    in_shardings: Tuple
    out_shardings: Any
    donate: Tuple[int, ...]
    rank_step: Optional[Callable] = None

    def trace(self, mesh=None):
        """Run the step once on its fake inputs under a cost counter;
        -> the `op_costs.CostCounter` (rows, costs, top ops, the inputs
        the step touched, the collectives' wire bytes).  `mesh`: a
        `DeviceMesh` of more than one rank -- this rank's part of the
        step on its blocks (`rank_step(mesh)` -> (step, inputs))."""
        from repro_torch.roofline.op_costs import CostCounter
        fn, args = self.fn, self.in_specs
        with registry.fake_mode():
            if partition.is_partitioned(mesh):
                if self.rank_step is None:
                    raise NotImplementedError(
                        f"no partitioned {self.kind} step")
                fn, args = self.rank_step(mesh)
            with CostCounter(watch=leaves(args)) as counter:
                fn(*args)
        return counter

    def floor_bytes(self, counter) -> int:
        """A floor on one step's device-memory bytes (the whole step,
        one rank): every input that the step touched (`counter`, from
        `trace()`) read once, and the donated ones written back once.  A
        decode step's cache is left out (the rows a step must read
        depend on the positions it is at), and so are activations: what
        any implementation of the step moves at least."""
        total = 0
        for i, arg in enumerate(self.in_specs):
            if self.kind == "decode" and i == 1:
                continue
            n = sum(x.numel() * x.element_size() for x in leaves(arg)
                    if counter.touches(x))
            total += n * (2 if i in self.donate else 1)
        return total

    def memory(self, mesh) -> dict:
        """`argument_size_in_bytes`: one rank's bytes of every input
        under its spec; `alias_size_in_bytes`: those of the donated
        inputs (the buffers the step updates in place)."""
        def arg_bytes(i):
            xs = leaves(self.in_specs[i])
            specs = spec_leaves(self.in_shardings[i])
            assert len(xs) == len(specs), (len(xs), len(specs))
            return sum(block_bytes(x, s, mesh) for x, s in zip(xs, specs))

        per_arg = [arg_bytes(i) for i in range(len(self.in_specs))]
        return {"argument_size_in_bytes": sum(per_arg),
                "alias_size_in_bytes": sum(per_arg[i] for i in self.donate)}


#: the mesh a plan's global `fn` runs on
_ONE_RANK = {"data": 1, "model": 1}


def params_and_shardings(cfg: ModelConfig, mesh):
    """(api, fake parameters in the reference's layout, their specs)."""
    api = registry.get_model(cfg)
    with registry.fake_mode():
        params = params_to_reference(api.init(None, "cpu"), cfg)
    pspecs = shard_rules.param_specs(params, cfg, mesh)
    return api, params, pspecs


def _port_params(params, cfg: ModelConfig):
    """The model's view of stacked parameters (`unbind` views)."""
    return params_from_reference(params, cfg, leaves(params)[0].device)


# ---------------------------------------------------------------------------
# Train step plan
# ---------------------------------------------------------------------------

def build_train_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     tc: Optional[TrainConfig] = None) -> LoweredPlan:
    tc = tc or TrainConfig(optimizer=optimizer_for(cfg))
    api, params, pspecs = params_and_shardings(cfg, mesh)
    opt_init, _ = make_optimizer(tc.optimizer)
    with registry.fake_mode():
        # the step counter is a host value the update reads: a constant
        opt = opt_init(params)._replace(
            step=torch.tensor(0, dtype=torch.int32))
    ospecs = shard_rules.opt_state_specs(opt, params, cfg, mesh)
    batch = registry.input_specs(cfg, shape)
    bspecs = shard_rules.batch_specs(batch, mesh)
    metrics_spec = {"loss": P(), "grad_norm": P(), "lr": P()}

    def rank_step(dmesh):
        part = partition.RankLayout(cfg, dmesh)
        ospecs_ = shard_rules.opt_state_specs(opt, params, cfg, dmesh)
        return make_train_step(api, tc, dmesh), (
            partition.cut(params, part.param_specs, dmesh, copy=False),
            partition.cut(opt, ospecs_, dmesh, copy=False),
            partition.batch_block(batch, dmesh))

    return LoweredPlan(
        kind="train",
        fn=make_train_step(api, tc, mesh=_ONE_RANK),
        in_specs=(params, opt, batch),
        in_shardings=(pspecs, ospecs, bspecs),
        out_shardings=(pspecs, ospecs, metrics_spec),
        donate=(0, 1),
        rank_step=rank_step,
    )


def _rank_serving(cfg: ModelConfig, params, dmesh):
    """(the rank's layout, its parameter blocks) for a serving step."""
    part = partition.RankLayout(cfg, dmesh)
    return part, partition.cut(params, part.param_specs, dmesh, copy=False)


def _rows(shape: ShapeConfig, dmesh) -> int:
    return shape.global_batch // partition.dp_size(dmesh)


# ---------------------------------------------------------------------------
# Prefill plan
# ---------------------------------------------------------------------------

def build_prefill_plan(cfg: ModelConfig, shape: ShapeConfig,
                       mesh) -> LoweredPlan:
    api, params, pspecs = params_and_shardings(cfg, mesh)
    batch = registry.input_specs(cfg, shape)
    bspecs = shard_rules.batch_specs(batch, mesh)
    # a decoder's step returns the decode specs' cache at seq_len (the
    # encoder-decoder's, longer, takes the same specs: both lengths
    # divide the model axis)
    template = registry.decode_input_specs(cfg, shape)["cache"]

    def prefill_step(params, batch):
        p = _port_params(params, cfg)
        if cfg.is_encdec:
            return api.prefill(p, batch, shape.seq_len, use_kernels=False)
        cache = tree_map(torch.zeros_like, template)
        views = cache_from_reference(cache, cfg)
        logits, new = api.prefill(p, batch, shape.seq_len,
                                  use_kernels=False, cache=views)
        return logits, cache_into_reference(cache, views, new, cfg)

    def rank_step(dmesh):
        part, blocks = _rank_serving(cfg, params, dmesh)
        rows = partition.batch_block(batch, dmesh)
        with registry.fake_mode():
            local = cache_to_reference(transformer.init_cache(
                cfg, _rows(shape, dmesh), shape.seq_len, "cpu", part), cfg)

        def step(params, batch):
            views = cache_from_reference(local, cfg)
            with bind_axes(dmesh):
                logits, new = api.prefill(
                    _port_params(params, cfg), batch, shape.seq_len,
                    use_kernels=False, cache=views, part=part)
            return logits, cache_into_reference(local, views, new, cfg)
        return step, (blocks, rows)

    cspecs = shard_rules.cache_specs(template, cfg, mesh)
    return LoweredPlan(
        kind="prefill",
        fn=prefill_step,
        in_specs=(params, batch),
        in_shardings=(pspecs, bspecs),
        out_shardings=(None, cspecs),
        donate=(),
        rank_step=rank_step,
    )


# ---------------------------------------------------------------------------
# Decode (serve_step) plan: one new token against a seq_len-deep cache
# ---------------------------------------------------------------------------

def build_decode_plan(cfg: ModelConfig, shape: ShapeConfig,
                      mesh) -> LoweredPlan:
    api, params, pspecs = params_and_shardings(cfg, mesh)
    specs = registry.input_specs(cfg, shape)     # {'cache', 'tokens'}
    cache, tokens = specs["cache"], specs["tokens"]
    cspecs = shard_rules.cache_specs(cache, cfg, mesh)
    tspecs = shard_rules.batch_specs(tokens, mesh)

    def serve_step(params, cache, tokens):
        views = cache_from_reference(cache, cfg)
        logits, new = api.decode_step(_port_params(params, cfg), views,
                                      tokens, use_kernels=False)
        return logits, cache_into_reference(cache, views, new, cfg)

    def rank_step(dmesh):
        part, blocks = _rank_serving(cfg, params, dmesh)

        def step(params, cache, tokens):
            views = cache_from_reference(cache, cfg)
            with bind_axes(dmesh):
                logits, new = api.decode_step(
                    _port_params(params, cfg), views, tokens,
                    use_kernels=False, part=part)
            return logits, cache_into_reference(cache, views, new, cfg)
        return step, (blocks, partition.cache_block(cache, part),
                      partition.batch_block(tokens, dmesh))

    return LoweredPlan(
        kind="decode",
        fn=serve_step,
        in_specs=(params, cache, tokens),
        in_shardings=(pspecs, cspecs, tspecs),
        out_shardings=(None, cspecs),
        donate=(1,),
        rank_step=rank_step,
    )


def build_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
               **kw) -> LoweredPlan:
    if shape.kind == "train":
        return build_train_plan(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_plan(cfg, shape, mesh)
    if shape.kind == "decode":
        return build_decode_plan(cfg, shape, mesh)
    raise ValueError(shape.kind)
