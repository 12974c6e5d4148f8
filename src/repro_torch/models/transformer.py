"""Decoder LM over every decoder block kind: the counterpart of
`repro.models.transformer` (dense, MoE, Mamba + MoE hybrid, RWKV and
early-fusion VLM configs).

The reference groups layers as [prefix] + n_super x [period] so that
`lax.scan` compiles one period (Jamba: a period of 8, Kimi: a prefix of
1); the port keeps `layer_layout` and `split_layout` but runs a plain
list of layers, layer `prefix_len + u·period + pos` being the
reference's `stacks[pos][u]` (`convert.py` carries parameters across).
A block is attention, Mamba or RWKV time mix, then a MoE layer (with
Arctic's dense residual MLP beside it), RWKV's channel mix or an MLP.

Caches are {'layers': [...], 'pos': (B,) int32}, a layer's entry being
{'kv': {'k', 'v'}} (each (B, S_max, KVH, hd)), {'ssm': {'h', 'conv'}}
or {'time': {'S', 'last'}, 'channel': {'last'}}; per-slot positions let
serving slots sit at different depths.  A forward writes the attention
caches' K and V in place and returns a new dict around them, the
recurrent states as new tensors, with pos advanced.

Training differentiates `loss_fn` with autograd (the MoE layers' aux
losses included); `remat` recomputes each layer's activations in the
backward pass (`torch.utils.checkpoint` per layer, where the reference
checkpoints each scanned super-block: the same recomputation).

`part=` (a `distributed.partition.RankLayout`) runs one rank's part of
the partitioned step: the parameters given are the rank's blocks (in the
model's per-layer layout), each layer's weights made from them at the
start of the layer (inside its recomputation, under remat: gathered
again in the backward pass, as FSDP does), the cache the rank's rows and
KV heads (`init_cache(part=)`), the logits its vocab block.

The encoder-decoder is `models.whisper`'s: its config raises
NotImplementedError here (`registry.get_model` dispatches it).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.api import constrain
from repro_torch.tree import tree_map
from . import mamba as _mamba
from . import moe as _moe
from . import rwkv6 as _rwkv
from .common import (apply_attention, apply_mlp, apply_norm, cache_index,
                     dtype_of, embed_init, init_attention, init_mlp,
                     init_norm, lm_loss, rope_dims, rope_tables)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def layer_layout(cfg: ModelConfig) -> List[Tuple[str, bool]]:
    return [(cfg.block_kind(i), cfg.is_moe_layer(i))
            for i in range(cfg.n_layers)]


def split_layout(cfg: ModelConfig):
    """-> (prefix_len, period, n_super); layout[prefix:] repeats `period`."""
    layout = layer_layout(cfg)
    n = len(layout)
    for prefix in range(0, 3):
        rem = n - prefix
        for period in range(1, 9):
            if rem % period:
                continue
            tail = layout[prefix:]
            if all(tail[i] == tail[i % period] for i in range(rem)):
                return prefix, period, rem // period
    return n, 1, 0   # fully irregular: all layers in prefix


def require_supported(cfg: ModelConfig) -> None:
    """Decoder-only configs: every block kind but the encoder-decoder."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-decoder config runs through "
            "models.whisper (registry.get_model dispatches it), not the "
            "decoder-only models.transformer")


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
               is_moe: bool, device) -> Params:
    p: Params = {"norm1": init_norm(cfg, device),
                 "norm2": init_norm(cfg, device)}
    if kind == "attn":
        p["attn"] = init_attention(gen, cfg, device)
    elif kind == "mamba":
        p["mamba"] = _mamba.init_mamba(gen, cfg, device)
    elif kind == "rwkv":
        p["time"] = _rwkv.init_rwkv_time(gen, cfg, device)
    else:
        raise ValueError(kind)
    if is_moe:
        p["moe"] = _moe.init_moe(gen, cfg, device)
        if cfg.moe.dense_residual:
            p["mlp"] = init_mlp(gen, cfg, device)
    elif kind == "rwkv":
        p["channel"] = _rwkv.init_rwkv_channel(gen, cfg, device)
    else:
        p["mlp"] = init_mlp(gen, cfg, device)
    return p


def apply_block(p: Params, cfg: ModelConfig, kind: str, is_moe: bool,
                x: torch.Tensor, positions, cache: Optional[Params],
                cache_pos, *, index=None, rope=None, use_kernels: bool = True,
                part=None
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (x, new_cache, aux_loss_scalar)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(p["norm1"], x)
    if kind == "attn":
        out, new_kv = apply_attention(
            p["attn"], cfg, h, positions,
            cache=cache["kv"] if cache else None, cache_pos=cache_pos,
            index=index, rope=rope, use_kernels=use_kernels, part=part)
        new_cache = {"kv": new_kv} if new_kv is not None else None
    elif kind == "mamba":
        out, new_ms = _mamba.apply_mamba(
            p["mamba"], cfg, h, state=cache["ssm"] if cache else None)
        new_cache = {"ssm": new_ms} if new_ms is not None else None
    elif kind == "rwkv":
        out, new_ts = _rwkv.apply_rwkv_time(
            p["time"], cfg, h, state=cache["time"] if cache else None)
        new_cache = {"time": new_ts} if new_ts is not None else None
    else:
        raise ValueError(kind)
    x = constrain(x + out, "dp", None, None)

    h2 = apply_norm(p["norm2"], x)
    if is_moe:
        mo, moe_aux = _moe.apply_moe_auto(p["moe"], cfg, h2)
        aux = aux + sum(moe_aux.values())
        if cfg.moe.dense_residual:
            mo = mo + apply_mlp(p["mlp"], cfg, h2)
        x = x + mo
    elif kind == "rwkv":
        co, new_cs = _rwkv.apply_rwkv_channel(
            p["channel"], cfg, h2, state=cache["channel"] if cache else None)
        if new_cache is not None or new_cs is not None:
            new_cache = dict(new_cache or {})
            new_cache["channel"] = new_cs
        x = x + co
    else:
        x = x + apply_mlp(p["mlp"], cfg, h2, part=part)
    x = constrain(x, "dp", None, None)
    return x, new_cache, aux


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device, n_kv: Optional[int] = None) -> Params:
    if kind == "attn":
        shape = (batch, max_len, n_kv or cfg.n_kv_heads, cfg.hd)
        return {"kv": {"k": torch.zeros(shape, dtype=dtype_of(cfg),
                                        device=device),
                       "v": torch.zeros(shape, dtype=dtype_of(cfg),
                                        device=device)}}
    if kind == "mamba":
        return {"ssm": _mamba.init_mamba_state(cfg, batch, device)}
    if kind == "rwkv":
        return _rwkv.init_rwkv_state(cfg, batch, device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Activation recomputation
# ---------------------------------------------------------------------------

REMAT = ("none", "dots", "full")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """`checkpoint_dots_with_no_batch_dims`: keep the 2-D matrix
    products (the weight GEMMs), recompute the rest -- the attention
    einsums, which are batched, included."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(remat: str) -> Optional[dict]:
    """`torch.utils.checkpoint.checkpoint` arguments of a remat mode, or
    None for "none"."""
    if remat not in REMAT:
        raise ValueError(f"remat={remat!r}: one of {REMAT}")
    if remat == "none":
        return None
    kw: dict = {"use_reentrant": False}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return kw


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Params:
    """Seeded parameters on `device` (None = the card), drawn from `gen`
    (a generator on that device; None = seed 0).  The draws are not the
    reference's threefry stream: to run the reference's parameters, carry
    them across with `convert.params_from_reference`."""
    require_supported(cfg)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    dt = dtype_of(cfg)
    p: Params = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, dev),
                 "final_norm": init_norm(cfg, dev)}
    if not cfg.tie_embeddings:
        p["head"] = embed_init(gen, cfg.vocab, cfg.d_model, dt, dev).T
    p["layers"] = [init_block(gen, cfg, kind, is_moe, dev)
                   for kind, is_moe in layer_layout(cfg)]
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None, part=None) -> Params:
    """`part`: a rank's cache of the partitioned step, `batch` its rows
    and the KV heads its query heads read."""
    require_supported(cfg)
    dev = resolve_device(device)
    n_kv = part.n_kv if part is not None else None
    return {"layers": [init_block_cache(cfg, kind, batch, max_len, dev, n_kv)
                       for kind, _ in layer_layout(cfg)],
            # per-slot positions: serving slots sit at different depths
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _batch_rows(n: int, slot, width: int) -> slice:
    """The reference's dynamic slice start, clamped so `width` rows fit."""
    start = max(0, min(int(slot), n - width))
    return slice(start, start + width)


def slice_cache(cache: Params, slot, width: int = 1) -> Params:
    """A copy of `width` batch rows starting at `slot`: every leaf's
    leading dim is the batch."""
    rows = _batch_rows(cache["pos"].shape[0], slot, width)
    return tree_map(lambda t: t[rows].clone(), cache)


def merge_cache(cache: Params, sub: Params, slot) -> Params:
    """Write a sliced sub-cache back into the batch at `slot`, in place
    (every leaf); returns the cache."""
    rows = _batch_rows(cache["pos"].shape[0], slot, sub["pos"].shape[0])

    def put(t, new):
        t[rows] = new.to(t.dtype)
        return t

    tree_map(put, cache, sub)
    return cache


def _first_kv(cache: Params) -> Optional[torch.Tensor]:
    """The first attention layer's K cache, or None (no attention)."""
    for layer in cache["layers"]:
        if "kv" in layer:
            return layer["kv"]["k"]
    return None


def forward(params: Params, cfg: ModelConfig, tokens=None, embeds=None,
            cache: Optional[Params] = None, remat: str = "full",
            use_kernels: bool = True, cache_start: Optional[int] = None,
            part=None
            ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """-> (hidden (B,S,d), new_cache, aux_loss).

    Training: cache None.  Prefill: a zero-pos cache.  Decode: S == 1.
    aux_loss sums the MoE layers' balance and z-losses (0 without MoE).
    `remat` ("none", "dots", "full") applies to a forward without a
    cache that autograd records.  `cache_start`: where a multi-token
    call writes the cache, when the caller knows it (`cache_index`).
    `part`: one rank's part of the partitioned step (module docstring)."""
    require_supported(cfg)
    if embeds is None:
        embeds = params["embed"][tokens.long()] if part is None \
            else part.embed(params["embed"], tokens)
    x = constrain(embeds, "dp", None, None)
    b, s, _ = x.shape
    dev = x.device
    layout = layer_layout(cfg)

    cache_pos = cache["pos"] if cache is not None else None
    steps = torch.arange(s, device=dev)
    positions = steps if cache is None else cache_pos[:, None] + steps[None]
    hd_rot = rope_dims(cfg.hd, cfg.rope_pct)
    rope = rope_tables(positions, hd_rot, cfg.rope_theta) if hd_rot else None
    index = None
    if cache is not None:
        k0 = _first_kv(cache)
        if k0 is not None:
            index = cache_index(cache_pos, k0.shape[1], s, use_kernels,
                                cache_start)

    remat_kw = _remat_kwargs(remat)
    if cache is not None or not torch.is_grad_enabled():
        remat_kw = None

    def weights(i, p):
        return p if part is None else part.layer(i, p)

    def train_block(i, p, kind, is_moe, x):
        x, _, aux = apply_block(weights(i, p), cfg, kind, is_moe, x,
                                positions, None, None, rope=rope,
                                use_kernels=use_kernels, part=part)
        return x, aux

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    new_layers = []
    for i, (p, (kind, is_moe)) in enumerate(zip(params["layers"], layout)):
        if remat_kw is not None:
            x, aux = checkpoint(train_block, i, p, kind, is_moe, x,
                                **remat_kw)
        else:
            blk_cache = cache["layers"][i] if cache is not None else None
            x, nc, aux = apply_block(weights(i, p), cfg, kind, is_moe, x,
                                     positions, blk_cache, cache_pos,
                                     index=index, rope=rope,
                                     use_kernels=use_kernels, part=part)
            new_layers.append(nc if nc is not None else blk_cache)
        aux_total = aux_total + aux

    final = params["final_norm"] if part is None \
        else part.leaf("final_norm", params["final_norm"])
    x = apply_norm(final, x)
    new_cache = None
    if cache is not None:
        new_cache = {"layers": new_layers, "pos": cache_pos + s}
    return x, new_cache, aux_total


def head_matrix(params: Params, cfg: ModelConfig, part=None
                ) -> torch.Tensor:
    """(d, V); with `part`, this rank's (d, V / model) block."""
    if part is not None:
        return part.leaf("embed", params["embed"]).T if cfg.tie_embeddings \
            else part.leaf("head", params["head"])
    return params["embed"].T if cfg.tie_embeddings else params["head"]


# ---------------------------------------------------------------------------
# Task-level entry points
# ---------------------------------------------------------------------------

def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            remat: str = "full", use_kernels: bool = True,
            part=None) -> torch.Tensor:
    """Mean next-token cross-entropy, differentiable by autograd with
    `use_kernels=False` (the plain attention, which the reference's
    training path runs).  The attention kernels have no backward: with
    `use_kernels=True` a loss whose parameters require grad raises.
    `part`: the global mean from this rank's blocks and rows."""
    x, _, aux = forward(params, cfg, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), remat=remat,
                        use_kernels=use_kernels, part=part)
    return lm_loss(head_matrix(params, cfg, part), x, batch["labels"],
                   part=part) + aux


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            max_len: int, use_kernels: bool = True,
            cache: Optional[Params] = None, part=None
            ) -> Tuple[torch.Tensor, Params]:
    """Run the prompt, build the cache, return last-position logits.
    `cache`: a zero cache of max_len positions to fill (default: a fresh
    `init_cache`).  `part`: this rank's rows, cache and vocab block."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    src = tokens if tokens is not None else embeds
    if cache is None:
        cache = init_cache(cfg, src.shape[0], max_len, device=src.device,
                           part=part)
    x, new_cache, _ = forward(params, cfg, tokens=tokens, embeds=embeds,
                              cache=cache, remat="none",
                              use_kernels=use_kernels, cache_start=0,
                              part=part)
    logits = x[:, -1:, :] @ head_matrix(params, cfg, part)
    return logits, new_cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, use_kernels: bool = True, part=None
                ) -> Tuple[torch.Tensor, Params]:
    """tokens: (B, 1) -> (logits (B,1,V), new_cache).  `part`: this
    rank's rows, cache and vocab block."""
    x, new_cache, _ = forward(params, cfg, tokens=tokens, cache=cache,
                              remat="none", use_kernels=use_kernels,
                              part=part)
    logits = x @ head_matrix(params, cfg, part)
    return logits, new_cache
