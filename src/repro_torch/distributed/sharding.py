"""Parameter/activation sharding rules (FSDP on 'data', TP on 'model'):
the counterpart of `repro.distributed.sharding`, rule for rule.

Rules are *logical* (axis names resolved against the mesh given) and
divisibility-checked: a dim that does not divide evenly falls back to
replication -- e.g. RWKV's 40 heads on a 16-way model axis, or GQA
kv-projections when kv_heads < model.  The mesh is a `DeviceMesh` or a
plain {axis name: size} dict, so the rules evaluate at the production
shapes (16 x 16, 2 x 16 x 16) without that many ranks.

Megatron-style layout:
    embed (V, d)            -> (model, data)     vocab-sharded
    head  (d, V)            -> (data, model)
    attn  wq/wk/wv (d, out) -> (data, model)     column parallel
    attn  wo (out, d)       -> (model, data)     row parallel
    mlp   up/gate (d, ff)   -> (data, model)
    mlp   down (ff, d)      -> (model, data)
    moe   experts (E, d, f) -> (model, data, -)  expert parallel + FSDP
    scalars / norms         -> replicated

The 'pod' axis is deliberately absent here: parameters are replicated
across pods (pure DP); only gradients cross it.  Leaves under a stack
('stacks', 'enc_stack', 'dec_stack') get a leading None for the layer
dimension.  The trees are the reference's layout (the train state's
`prefix` / `stacks`); a leaf is anything with a `.shape`.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import map_with_keys
from .api import P, mesh_dict, resolve_axis

Params = Any

_STACK_MARKERS = ("stacks", "enc_stack", "dec_stack")

# (name-suffix, logical spec per trailing dims)
_RULES_2D = {
    "embed": ("model", "data"),
    "tok_embed": ("model", "data"),
    "head": ("data", "model"),
    "wq": ("data", "model"),
    "wk": ("data", "kv_model"),      # kv_model: model iff kv divisible
    "wv": ("data", "kv_model"),
    "wo": ("model", "data"),
    "wg": ("data", "model"),
    "wr": ("data", "model"),
    "w_up": ("data", "model"),
    "w_gate": ("data", "model"),
    "w_down": ("model", "data"),
    "in_proj": ("data", "model"),
    "out_proj": ("model", "data"),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "A_log": ("model", None),
    "conv_w": (None, "model"),
    "wA": ("data", None),
    "wB": (None, "model"),
    "router": ("data", None),
    "dec_pos": (None, "data"),
}

_RULES_3D = {
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
    "shared_gate": (None, "data", "model"),
    "shared_up": (None, "data", "model"),
    "shared_down": (None, "model", "data"),
}

_RULES_1D = {
    "bq": ("model",),
    "bk": ("kv_model",),
    "bv": ("kv_model",),
    "conv_b": ("model",),
    "dt_bias": ("model",),
    "D": ("model",),
}


def _leaf_name(path) -> str:
    for entry in reversed(path):
        if isinstance(entry, str):
            return entry
    return ""


def _in_stack(path) -> bool:
    return any(isinstance(entry, str) and entry in _STACK_MARKERS
               for entry in path)


def _axis_size(mesh, logical: Optional[str]) -> int:
    axis = resolve_axis(mesh, logical)
    if axis is None:
        return 1
    sizes = mesh_dict(mesh)
    size = 1
    for a in spec_axes(axis):
        size *= sizes[a]
    return size


def spec_for_leaf(path, shape: Tuple[int, ...], cfg: ModelConfig,
                  mesh) -> P:
    name = _leaf_name(path)
    stacked = _in_stack(path)
    dims = shape[1:] if stacked else shape
    rank = len(dims)
    table = {1: _RULES_1D, 2: _RULES_2D, 3: _RULES_3D}.get(rank, {})
    logical = table.get(name)
    if logical is None and rank >= 2:
        # fallback: biggest-dims heuristic (covers future additions)
        logical = tuple([None] * (rank - 2) + ["data", "model"])
    if logical is None:
        logical = (None,) * rank

    resolved = []
    for dim_size, lax_name in zip(dims, logical):
        if lax_name == "kv_model":
            lax_name = "model" if cfg.n_kv_heads % _axis_size(
                mesh, "model") == 0 else None
        if lax_name is None:
            resolved.append(None)
            continue
        if dim_size % max(_axis_size(mesh, lax_name), 1) != 0:
            resolved.append(None)        # not divisible -> replicate
            continue
        resolved.append(resolve_axis(mesh, lax_name))
    if stacked:
        resolved = [None] + resolved
    return P(*resolved)


def param_specs(params_shape: Params, cfg: ModelConfig, mesh) -> Params:
    """A tree of leaves with `.shape` -> the tree of their P."""
    return map_with_keys(lambda path, leaf: spec_for_leaf(
        path, tuple(leaf.shape), cfg, mesh), params_shape)


# ---------------------------------------------------------------------------
# Optimizer-state shardings (derived from the param specs, never re-derived
# from leaf names: moment tensors must be axis-aligned with their parameter
# or every optimizer step pays a resharding collective)
# ---------------------------------------------------------------------------

def opt_state_specs(opt_state_shape: Params, params_shape: Params,
                    cfg: ModelConfig, mesh) -> Params:
    """Specs for AdamWState / AdafactorState, built by construction.

    mu/nu mirror the param spec exactly (axis-aligned moments -> no
    resharding in the update).  Adafactor's factored stats drop the last
    (vr) / second-to-last (vc) dim of the param spec.  Scalars and the
    step counter are replicated.
    """
    from repro_torch.optim.adamw import AdafactorState, AdamWState

    pspecs = param_specs(params_shape, cfg, mesh)
    if isinstance(opt_state_shape, AdamWState):
        return AdamWState(step=P(), mu=pspecs, nu=pspecs)
    if not isinstance(opt_state_shape, AdafactorState):
        raise TypeError(f"unknown optimizer state {type(opt_state_shape)}")

    def _fit(axes, leaf_shape):
        axes = tuple(axes)[: len(leaf_shape)]
        axes = axes + (None,) * (len(leaf_shape) - len(axes))
        return P(*axes)

    def factored(drop):
        def one(path, p):
            shape = tuple(p.shape)
            if len(shape) < 2:      # <2-D params use v_full; vr/vc scalars
                return P()
            spec = spec_for_leaf(path, shape, cfg, mesh)
            t = tuple(spec) + (None,) * (len(shape) - len(spec))
            if drop == "last":
                return _fit(t[:-1], shape[:-1])
            return _fit(t[:-2] + t[-1:], shape[:-2] + shape[-1:])
        return map_with_keys(one, params_shape)

    return AdafactorState(step=P(), vr=factored("last"),
                          vc=factored("second"),
                          v_full=map_with_keys(lambda *_: P(), params_shape))


# ---------------------------------------------------------------------------
# Data / cache shardings
# ---------------------------------------------------------------------------

def batch_specs(batch_shape: Params, mesh) -> Params:
    """Shard the leading (global-batch) dim of every input on dp."""
    dp = resolve_axis(mesh, "dp")
    total_dp = _axis_size(mesh, "dp")

    def one(path, leaf):
        dims = [None] * len(leaf.shape)
        if len(leaf.shape) and leaf.shape[0] % max(total_dp, 1) == 0:
            dims[0] = dp
        return P(*dims)

    return map_with_keys(one, batch_shape)


def cache_specs(cache_shape: Params, cfg: ModelConfig, mesh) -> Params:
    """KV caches: batch on dp AND sequence on model (both where divisible).

    The batch dim shards on dp and the KV length dim on model (GQA kv=8
    heads cannot take a 16-way axis); a batch of 1 gets sequence
    sharding only.  Non-KV state (SSM/RWKV states, enc_out) shards its
    batch dim and, for enc_out, sequence too.
    """
    dp = resolve_axis(mesh, "dp")
    dp_size = _axis_size(mesh, "dp")
    model = resolve_axis(mesh, "model")
    model_size = _axis_size(mesh, "model")

    def one(path, leaf):
        shape = tuple(leaf.shape)
        name = _leaf_name(path)
        dims: list = [None] * len(shape)
        stacked = _in_stack(path)
        rank = len(shape)
        if rank == 0:
            return P()
        # find the batch dim: stacked caches are (L, B, ...), prefix (B, ...)
        b_dim = 1 if (stacked and rank >= 2) else 0
        if b_dim >= rank:
            return P(*dims)
        if shape[b_dim] % max(dp_size, 1) == 0 and shape[b_dim] > 1:
            dims[b_dim] = dp
        if name in ("k", "v", "enc_out") and rank >= b_dim + 2:
            # sequence dim: (L, B, S, KV, hd) / (B, S, KV, hd) / (B, S, d)
            s_dim = b_dim + 1
            if (shape[s_dim] % max(model_size, 1) == 0
                    and shape[s_dim] >= 4 * model_size):
                dims[s_dim] = model
        return P(*dims)

    return map_with_keys(one, cache_shape)


def map_specs(fn, specs):
    """fn over the `P` leaves of a spec tree (a P is a tuple, but a leaf
    here)."""
    if isinstance(specs, P):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(type(specs), "_fields"):
        return type(specs)(*(map_specs(fn, v) for v in specs))
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, v) for v in specs)
    return specs


def spec_leaves(specs) -> list:
    """The `P` leaves of a spec tree in JAX's order (dict keys sorted)."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in spec_leaves(v)]
    return []


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_of(x, spec: P, mesh):
    """This rank's block of the global `x` under `spec`, as a view: the
    block `NamedSharding` gives the device at this rank's mesh
    coordinates, row-major over each entry's axes (the cut `shard_map`
    hands its body)."""
    sizes = mesh_dict(mesh)
    if len(spec) > x.dim():
        raise ValueError(f"shard_map: spec {spec} has more entries than "
                         f"the rank-{x.dim()} input")
    for dim, entry in enumerate(spec):
        idx, n = 0, 1
        for name in spec_axes(entry):
            if name not in sizes:
                raise ValueError(f"shard_map: axis {name!r} is not an "
                                 f"axis of the mesh {tuple(sizes)}")
            idx = idx * sizes[name] + mesh.get_local_rank(name)
            n *= sizes[name]
        if x.shape[dim] % n:
            raise ValueError(f"shard_map: dimension {dim} of size "
                             f"{x.shape[dim]} does not split into the {n} "
                             f"blocks of {entry!r}")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x
