"""Carry the reference's parameters into the port.

The reference's parameter tree (`repro.models.transformer.init_params`)
holds `embed`, `final_norm`, `head` (unless tied), a `prefix` list of
blocks and `stacks`: per period position a block whose every leaf has a
leading n_super dim.  Given that tree with numpy leaves (for example
`jax.tree.map(np.asarray, params)`), `params_from_reference` returns the
port's: the same leaves, bytes unchanged, with layer `prefix_len +
u·period + pos` taken from `stacks[pos][...][u]`.  Weights stay (d_in,
d_out).  bfloat16 leaves (numpy's `ml_dtypes` type, which
`torch.from_numpy` refuses) cross as their raw 16-bit words.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device, to_tensor
from .transformer import require_supported, split_layout


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def params_from_reference(ref: Any, cfg: ModelConfig, device=None) -> dict:
    require_supported(cfg)
    dev = resolve_device(device)
    prefix_len, period, n_super = split_layout(cfg)

    def leaf(a):
        return to_tensor(a, dev)

    out = {name: _map(ref[name], leaf)
           for name in ("embed", "final_norm", "head") if name in ref}
    layers = [_map(ref["prefix"][i], leaf) for i in range(prefix_len)]
    for u in range(n_super):
        for pos in range(period):
            layers.append(_map(ref["stacks"][pos], lambda a: leaf(a[u])))
    out["layers"] = layers
    return out
