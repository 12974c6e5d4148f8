"""Carry parameters and optimizer states between the reference's layout
and the port's.

The reference's parameter tree (`repro.models.transformer.init_params`)
holds `embed`, `final_norm`, `head` (unless tied), a `prefix` list of
blocks and `stacks`: per period position a block whose every leaf has a
leading n_super dim.  The port's model runs a plain `layers` list, layer
`prefix_len + u·period + pos` being `stacks[pos][...][u]`.  Weights stay
(d_in, d_out) in both.  Every block kind's leaves cross the same way:
a MoE layer's (n_super, E, d, ff) expert stacks and router, Mamba's
A_log, D and conv weights, RWKV's u, mixes and ln_x; a stacked leaf
splits along its first dim only.  The encoder-decoder's tree
(`repro.models.whisper.init_params`) holds `tok_embed`, `dec_pos`,
`enc_norm`, `dec_norm` and the stacked `enc_stack` / `dec_stack`, which
the port runs as the lists `enc_layers` / `dec_layers`.

  params_from_reference  the reference's tree (numpy, jax or torch
                         leaves) -> the port's; a stacked leaf becomes one
                         tensor whose `unbind(0)` views are the layers'
                         leaves, bytes unchanged, so autograd through the
                         views sums into the stacked tensor
  params_to_reference    the port's tree -> the reference's layout, as
                         tensors on the parameters' device (layers
                         stacked, `head` a row-major (d, V) copy)
  opt_state_from_reference  the reference's AdamWState / AdafactorState ->
                         the port's, leaves as tensors on a device, the
                         step an int32 host tensor
  cache_to_reference     a decoder's cache {'layers', 'pos'} -> the
                         reference's {'prefix', 'stacks', 'pos'} (layers
                         stacked); an encoder-decoder's is the same in both
  cache_from_reference   the other way, stacked leaves as `unbind` views:
                         a forward writing a layer's K/V in place writes
                         the stacked tensor
  cache_into_reference   after such a forward, the new recurrent states
                         copied into the stacked tensors, in place (a
                         donated buffer's update)

The trainer (`train.loop`) holds its parameters and optimizer state in
the reference's layout: the reference's optimizers decide weight decay
and Adafactor's factoring by a leaf's dims and clip Adafactor's update
by a leaf's RMS, so a stacked leaf is one leaf to them.  Its checkpoints
therefore have the reference's keys and bytes.  bfloat16 numpy leaves
(`ml_dtypes`, which `torch.from_numpy` refuses) cross as their raw
16-bit words.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, to_tensor
from repro_torch.optim import AdafactorState, AdamWState
from repro_torch.tree import leaves, tree_map
from .transformer import split_layout


#: the encoder-decoder's stacked blocks and the port's lists of them
ENCDEC_STACKS = (("enc_stack", "enc_layers"), ("dec_stack", "dec_layers"))


def _unstack(tree, n: int, leaf):
    """A stacked block -> n blocks of views (one unbind a leaf)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n, leaf) for k, v in tree.items()}
        return [{k: parts[k][u] for k in tree} for u in range(n)]
    return leaf(tree).unbind(0)


def _stack(blocks: list):
    return tree_map(lambda *xs: torch.stack(xs), *blocks)


def params_from_reference(ref: Any, cfg: ModelConfig, device=None) -> dict:
    dev = resolve_device(device)

    def leaf(a):
        return to_tensor(a, dev)

    if cfg.is_encdec:
        out = {name: tree_map(leaf, ref[name]) for name in
               ("tok_embed", "dec_pos", "enc_norm", "dec_norm")}
        for stack, layers in ENCDEC_STACKS:
            n = cfg.n_encoder_layers if stack == "enc_stack" \
                else cfg.n_layers
            out[layers] = _unstack(ref[stack], n, leaf)
        return out
    prefix_len, period, n_super = split_layout(cfg)
    out = {name: tree_map(leaf, ref[name])
           for name in ("embed", "final_norm", "head") if name in ref}
    layers = [tree_map(leaf, ref["prefix"][i]) for i in range(prefix_len)]
    stacks = [_unstack(ref["stacks"][pos], n_super, leaf)
              for pos in range(period)] \
        if n_super else []
    for u in range(n_super):
        for pos in range(period):
            layers.append(stacks[pos][u])
    out["layers"] = layers
    return out


def params_to_reference(params: dict, cfg: ModelConfig) -> dict:
    if cfg.is_encdec:
        out = {name: params[name] for name in ("tok_embed", "dec_pos")}
        out.update({name: dict(params[name])
                    for name in ("enc_norm", "dec_norm")})
        for stack, layers in ENCDEC_STACKS:
            out[stack] = _stack(params[layers])
        return out
    prefix_len, period, n_super = split_layout(cfg)
    layers = params["layers"]
    out = {"embed": params["embed"],
           "final_norm": dict(params["final_norm"])}
    if "head" in params:
        out["head"] = params["head"].contiguous()
    out["prefix"] = [layers[i] for i in range(prefix_len)]
    out["stacks"] = [
        _stack([layers[prefix_len + u * period + pos]
                for u in range(n_super)]) if n_super else None
        for pos in range(period)]
    return out


def opt_state_from_reference(ref_state: Any, device=None):
    """The reference's optimizer state (a NamedTuple with numpy or jax
    leaves) -> the port's class of the same name over tensors."""
    dev = resolve_device(device)
    cls = {"AdamWState": AdamWState,
           "AdafactorState": AdafactorState}[type(ref_state).__name__]
    step = torch.tensor(int(ref_state.step), dtype=torch.int32)
    return cls(step, *(tree_map(lambda a: to_tensor(a, dev), t)
                       for t in ref_state[1:]))


def cache_to_reference(cache: dict, cfg: ModelConfig) -> dict:
    if cfg.is_encdec:
        return cache
    prefix_len, period, n_super = split_layout(cfg)
    layers = cache["layers"]
    return {"prefix": [layers[i] for i in range(prefix_len)],
            "pos": cache["pos"],
            "stacks": [_stack([layers[prefix_len + u * period + pos]
                               for u in range(n_super)]) if n_super else None
                       for pos in range(period)]}


def cache_from_reference(ref: dict, cfg: ModelConfig) -> dict:
    if cfg.is_encdec:
        return ref
    prefix_len, period, n_super = split_layout(cfg)
    stacks = [_unstack(ref["stacks"][pos], n_super, lambda t: t)
              for pos in range(period)] if n_super else []
    return {"layers": list(ref["prefix"][:prefix_len])
            + [stacks[pos][u] for u in range(n_super)
               for pos in range(period)],
            "pos": ref["pos"]}


def cache_into_reference(ref: dict, views: dict, new: dict,
                         cfg: ModelConfig) -> dict:
    """`ref` after a forward that ran on `views` (its
    `cache_from_reference`) and returned `new`: every leaf of `new` that
    is not the view it replaces is copied into it, in place; the
    positions are `new`'s."""
    if cfg.is_encdec:
        return new
    for old, cur in zip(leaves(views["layers"]), leaves(new["layers"])):
        if cur is not old:
            old.copy_(cur)
    return dict(ref, pos=new["pos"])
