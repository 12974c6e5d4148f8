"""The partitioned step: each rank of a (pod, data, model) mesh computes
its part of a dense decoder's train, prefill and decode steps from the
blocks it holds -- what the reference gets from XLA's SPMD partitioner
when it jits the same step under its sharding rules
(`repro.launch.steps`).

What a rank holds: its block of every parameter and optimizer-state
leaf under `sharding.param_specs` / `opt_state_specs` (`cut`), and its
`dp` rows of the batch under `batch_specs` (the rows' `dp` block of a
cache).  The rules are FSDP on `data` and Megatron's tensor parallelism
on `model`; parameters are replicated over `pod`.

What it computes, through `distributed.autograd`'s collectives (`use`):
  * each weight's `data` blocks gathered (FSDP; the backward reduce-
    scatters the gradient), its `model` block used as Megatron does:
    wq / wk / wv, w_up / w_gate and the head column-parallel (after f:
    identity forward, a sum over `model` backward), wo and w_down
    row-parallel (then g: a sum over `model` forward, identity
    backward); norms replicated;
  * a leaf replicated over a `dp` axis gets its gradient summed over it
    (every `dp` member holds other rows);
  * the embedding vocab-parallel: the rows in this rank's vocab block
    looked up, the others zero, then g;
  * attention head-parallel: this rank's n_heads / model query heads and
    the KV heads they read.  Where the rules replicate wk / wv (KV heads
    that do not split over `model`) the rank takes the KV heads its
    query heads map to, and their gradient is summed over `model` too;
  * the loss vocab-parallel: log-sum-exp from a `pmax` shift and a sum
    over `model` of the exponentials, the gold logit from the rank that
    holds the label, then the total and the count summed over `dp`: the
    global mean, the same bits on every rank;
  * the gradient norm: each leaf's squares summed over the axes the leaf
    is sharded on, a replicated leaf counted once; AdamW is elementwise
    on the blocks (weight decay by the leaf's dims, which a block
    keeps).

Every sum folds in mesh order, so replicated values (the loss, the norm,
norms' and replicated leaves' updates) are the same bits on every rank.

The partitioned step covers the dense family (attention blocks and an
MLP: MHA or GQA, qkv biases, SwiGLU or GELU, LayerNorm or RMSNorm) with
AdamW.  The MoE, hybrid, RWKV, encoder-decoder and VLM families wait for
ROADMAP A11, slice 3g (`require_partitioned`).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import leaves, tree_map
from . import api
from . import autograd as AG
from .sharding import (P, batch_specs, block_of, map_specs, param_specs,
                       spec_axes, spec_leaves)

Params = Any

SLICE_3G = "ROADMAP A11, slice 3g"
KV_LEAVES = ("wk", "wv", "bk", "bv")


def is_partitioned(mesh) -> bool:
    """A mesh of more than one rank (the step on one rank is the
    unpartitioned one)."""
    return mesh is not None and math.prod(api.mesh_dict(mesh).values()) > 1


def require_partitioned(cfg: ModelConfig) -> None:
    """The families the partitioned step covers: the dense decoders."""
    if cfg.is_encdec or cfg.family != "dense" or cfg.moe is not None \
            or set(cfg.block_pattern) != {"attn"}:
        raise NotImplementedError(
            f"{cfg.name}: the partitioned step covers the dense decoders; "
            f"the {cfg.family} family's partitioned step waits for "
            f"{SLICE_3G}")


def _port_specs(pspecs: Params, cfg: ModelConfig) -> Params:
    """The reference layout's spec tree -> the model's (a stacked leaf's
    layer dimension dropped, one entry a layer)."""
    from repro_torch.models.transformer import split_layout

    prefix_len, period, n_super = split_layout(cfg)
    out = {k: pspecs[k] for k in ("embed", "final_norm", "head")
           if k in pspecs}
    per_pos = [map_specs(lambda s: P(*s[1:]), pspecs["stacks"][pos])
               for pos in range(period)] if n_super else []
    out["layers"] = [pspecs["prefix"][i] for i in range(prefix_len)] \
        + [per_pos[pos] for _ in range(n_super) for pos in range(period)]
    return out


class RankLayout:
    """One rank's part of the step on `mesh` (a `DeviceMesh`): the
    widths it computes and how each parameter block becomes the weight it
    multiplies by.  The model (`models.transformer`, `models.common`)
    takes it as `part=`."""

    def __init__(self, cfg: ModelConfig, mesh):
        from repro_torch.models import registry
        from repro_torch.models.convert import params_to_reference

        require_partitioned(cfg)
        sizes = api.mesh_dict(mesh)
        self.cfg, self.mesh = cfg, mesh
        self.dp = tuple(a for a in ("pod", "data") if a in sizes)
        self.model_axes = ("model",) if "model" in sizes else ()
        m = sizes.get("model", 1)
        j = mesh.get_local_rank("model") if m > 1 else 0
        for what, n in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff),
                        ("vocab", cfg.vocab)):
            if n % m:
                raise ValueError(
                    f"{cfg.name}: {what}={n} does not split over the model "
                    f"axis of {m}: the partitioned step splits every "
                    "column-parallel width over it")
        self.n_q = cfg.n_heads // m
        q0 = j * self.n_q
        group = cfg.n_heads // cfg.n_kv_heads
        self.kv_split = cfg.n_kv_heads % m == 0
        if self.kv_split:
            per = cfg.n_kv_heads // m
            kv = list(range(j * per, (j + 1) * per))
        else:
            kv = sorted({(q0 + t) // group for t in range(self.n_q)})
            g = self.n_q // len(kv)
            if self.n_q % len(kv) or any(
                    (q0 + t) // group - kv[0] != t // g
                    for t in range(self.n_q)):
                kv = [(q0 + t) // group for t in range(self.n_q)]
        self.kv_heads = tuple(kv)
        self.n_kv = len(kv)
        self.n_vocab = cfg.vocab // m
        self.vocab0 = j * self.n_vocab
        api_ = registry.get_model(cfg)
        with registry.fake_mode():
            shapes = params_to_reference(api_.init(None, "cpu"), cfg)
        self.param_specs = param_specs(shapes, cfg, mesh)
        self.specs = _port_specs(self.param_specs, cfg)

    # -- weights ------------------------------------------------------------

    def use(self, block: torch.Tensor, spec: P, partial: bool = False
            ) -> torch.Tensor:
        """The weight this rank multiplies by, from its block: gathered
        over the `dp` axes the spec names (the backward reduce-scatters),
        its gradient summed over the `dp` axes the spec does not name
        and, for a leaf replicated over `model` that this rank uses only
        part of (`partial`), over `model`."""
        named = {a for e in spec for a in spec_axes(e)}
        sums = [a for a in self.dp if a not in named]
        if partial and self.model_axes and "model" not in named:
            sums.append("model")
        t = AG.enter(block, sums)
        for dim, entry in enumerate(spec):
            for name in spec_axes(entry):
                if name != "model":
                    t = AG.all_gather(t, name, dim)
        return t

    def _kv_columns(self, t: torch.Tensor) -> torch.Tensor:
        """A replicated K / V projection (or bias) -> the columns of the
        KV heads this rank's query heads read."""
        hd, heads = self.cfg.hd, self.kv_heads
        if heads == tuple(range(heads[0], heads[0] + len(heads))):
            return t.narrow(-1, heads[0] * hd, len(heads) * hd)
        idx = torch.tensor([h * hd + c for h in heads for c in range(hd)],
                           device=t.device)
        return t.index_select(-1, idx)

    def _walk(self, p, spec, name=""):
        if isinstance(p, dict):
            return {k: self._walk(p[k], spec[k], k) for k in p}
        sliced = name in KV_LEAVES and not self.kv_split
        t = self.use(p, spec, partial=sliced)
        return self._kv_columns(t) if sliced else t

    def layer(self, i: int, p: Params) -> Params:
        """Layer i's weights from its blocks."""
        return self._walk(p, self.specs["layers"][i])

    def leaf(self, name: str, p: Params) -> Params:
        """A top-level entry's weights ("embed", "final_norm", "head")."""
        return self._walk(p, self.specs[name], name)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """Vocab-parallel lookup: this rank's vocab rows, the others
        zero, summed over `model`."""
        e = self.leaf("embed", table)
        local = tokens.long() - self.vocab0
        mine = (local >= 0) & (local < self.n_vocab)
        x = e[local.clamp(0, self.n_vocab - 1)]
        x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
        return AG.psum(x, self.model_axes)

    # -- activations ---------------------------------------------------------

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f, before a column-parallel matmul."""
        return AG.enter(x, self.model_axes)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """Megatron's g, after a row-parallel matmul."""
        return AG.psum(y, self.model_axes)

    def vocab_max(self, x: torch.Tensor) -> torch.Tensor:
        return AG.pmax(x, self.model_axes)

    def vocab_sum(self, x: torch.Tensor) -> torch.Tensor:
        return AG.psum(x, self.model_axes)

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return AG.psum(x, self.dp)

    # -- the optimizer -------------------------------------------------------

    def global_norm(self, grads: Params) -> torch.Tensor:
        """The global gradient norm from the blocks: each leaf's squares
        summed over the axes it is sharded on (once, a group of leaves
        at a time); a leaf replicated over an axis is counted once."""
        groups: dict = {}
        for g, spec in zip(leaves(grads), spec_leaves(self.param_specs)):
            axes = tuple(sorted({a for e in spec for a in spec_axes(e)}))
            groups.setdefault(axes, []).append(g.float().square().sum())
        total = None
        for axes in sorted(groups):
            part = torch.stack(groups[axes]).sum()
            for name in axes:
                part = api.psum(part, name)
            total = part if total is None else total + part
        return torch.sqrt(total)


# ---------------------------------------------------------------------------
# Blocks of global trees, and global trees from blocks
# ---------------------------------------------------------------------------

def _pairs(tree, specs):
    """(leaf, spec) of a tree and its spec tree, in `leaves` order."""
    xs, ss = leaves(tree), spec_leaves(specs)
    if len(xs) != len(ss):
        raise ValueError(f"{len(xs)} leaves for {len(ss)} specs")
    return list(zip(xs, ss))


def cut(tree, specs, mesh, copy: bool = True):
    """This rank's block of every leaf of a global tree (`block_of`), as
    its own tensors (`copy`) or as views."""
    from repro_torch.tree import unflatten

    out = []
    for x, s in _pairs(tree, specs):
        b = block_of(x, s, mesh) if x.dim() else x
        out.append(b.clone() if copy and b is not x else b)
    return unflatten(tree, out)


def assemble(tree, specs, mesh):
    """The global tree from every rank's blocks: all-gathers along the
    axes each spec names.  Every rank calls it and gets the whole."""
    from repro_torch.tree import unflatten

    out = []
    with api.bind_axes(mesh):
        for x, s in _pairs(tree, specs):
            out.append(api._assemble(x, s, mesh) if x.dim() else x)
    return unflatten(tree, out)


def batch_block(batch, mesh):
    """This rank's `dp` rows of a global batch (every row count must
    split over `dp`)."""
    specs = batch_specs(batch, mesh)
    for x, s in _pairs(batch, specs):
        if x.dim() and s[0] is None and dp_size(mesh) > 1:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"over the dp axes of {dp_size(mesh)} ranks")
    return cut(batch, specs, mesh, copy=False)


def dp_size(mesh) -> int:
    """The ranks that hold other rows: the product of the dp axes."""
    sizes = api.mesh_dict(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def cache_block(cache, part: RankLayout):
    """This rank's block of a global cache in the reference's layout
    ({'prefix', 'stacks', 'pos'}): its `dp` rows, and the KV heads its
    query heads read."""
    def one(t, stacked):
        b = 1 if stacked else 0
        n = dp_size(part.mesh)
        if t.dim() > b and n > 1:
            size = t.shape[b] // n
            t = t.narrow(b, _dp_index(part.mesh) * size, size)
        if t.dim() == b + 4:                    # (.., B, S, KVH, hd)
            heads = part.kv_heads
            if heads == tuple(range(heads[0], heads[0] + len(heads))):
                return t.narrow(b + 2, heads[0], len(heads))
            return t.index_select(b + 2, torch.tensor(heads,
                                                      device=t.device))
        return t

    return {"prefix": tree_map(lambda t: one(t, False), cache["prefix"]),
            "stacks": tree_map(lambda t: one(t, True), cache["stacks"]),
            "pos": one(cache["pos"], False)}


def _dp_index(mesh) -> int:
    sizes = api.mesh_dict(mesh)
    idx = 0
    for a in ("pod", "data"):
        if a in sizes:
            idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx
