"""Decoder LM over attention blocks: the counterpart of
`repro.models.transformer`, for dense and early-fusion VLM configs
(granite-8b, stablelm-1.6b, starcoder2-15b, qwen2-72b, chameleon-34b).

The reference groups layers as [prefix] + n_super x [period] so that
`lax.scan` compiles one period; the port keeps `layer_layout` and
`split_layout` but runs a plain list of layers, layer `prefix_len +
u·period + pos` being the reference's `stacks[pos][u]` (`convert.py`
carries parameters across).  Caches are {'layers': [{'kv': {'k', 'v'}}],
'pos': (B,) int32}: every layer's K and V are (B, S_max, KVH, hd), and
per-slot positions let serving slots sit at different depths.  A forward
writes the cache's K and V in place and returns a new dict around them
with pos advanced.

Training differentiates `loss_fn` with autograd; `remat` recomputes
each layer's activations in the backward pass (`torch.utils.checkpoint`
per layer; the reference checkpoints each scanned super-block, the same
layers here: every ported config has period 1 and no prefix).

Mamba, RWKV and MoE blocks and the encoder-decoder wait for ROADMAP A11,
slice 3: their configs raise NotImplementedError.
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
    """Attention blocks without MoE only, decoder-only."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model is not ported yet "
            "(ROADMAP A11, slice 3)")
    other = sorted({f"{kind}{' + MoE' if moe else ''}"
                    for kind, moe in layer_layout(cfg)
                    if kind != "attn" or moe})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(other)} blocks are not ported yet "
            "(ROADMAP A11, slice 3)")


# ---------------------------------------------------------------------------
# One block
# ---------------------------------------------------------------------------

def init_block(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {"norm1": init_norm(cfg, device), "norm2": init_norm(cfg, device),
            "attn": init_attention(gen, cfg, device),
            "mlp": init_mlp(gen, cfg, device)}


def apply_block(p: Params, cfg: ModelConfig, x: torch.Tensor, positions,
                cache: Optional[Params], cache_pos, *, index=None, rope=None,
                use_kernels: bool = True
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (x, new_cache)."""
    h = apply_norm(p["norm1"], x)
    out, new_kv = apply_attention(
        p["attn"], cfg, h, positions, cache=cache["kv"] if cache else None,
        cache_pos=cache_pos, index=index, rope=rope, use_kernels=use_kernels)
    x = constrain(x + out, "dp", None, None)
    x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["norm2"], x))
    x = constrain(x, "dp", None, None)
    return x, ({"kv": new_kv} if new_kv is not None else None)


def init_block_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device) -> Params:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
                   "v": torch.zeros(shape, dtype=dtype_of(cfg),
                                    device=device)}}


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
    p["layers"] = [init_block(gen, cfg, dev) for _ in range(cfg.n_layers)]
    return p


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Params:
    require_supported(cfg)
    dev = resolve_device(device)
    return {"layers": [init_block_cache(cfg, batch, max_len, dev)
                       for _ in range(cfg.n_layers)],
            # per-slot positions: serving slots sit at different depths
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _batch_rows(n: int, slot, width: int) -> slice:
    """The reference's dynamic slice start, clamped so `width` rows fit."""
    start = max(0, min(int(slot), n - width))
    return slice(start, start + width)


def slice_cache(cache: Params, slot, width: int = 1) -> Params:
    """A copy of `width` batch rows starting at `slot`."""
    rows = _batch_rows(cache["pos"].shape[0], slot, width)
    return {"layers": [{"kv": {n: t[rows].clone()
                               for n, t in layer["kv"].items()}}
                       for layer in cache["layers"]],
            "pos": cache["pos"][rows].clone()}


def merge_cache(cache: Params, sub: Params, slot) -> Params:
    """Write a sliced sub-cache back into the batch at `slot`, in place;
    returns the cache."""
    rows = _batch_rows(cache["pos"].shape[0], slot, sub["pos"].shape[0])
    for layer, sub_layer in zip(cache["layers"], sub["layers"]):
        for name, t in layer["kv"].items():
            t[rows] = sub_layer["kv"][name].to(t.dtype)
    cache["pos"][rows] = sub["pos"].to(cache["pos"].dtype)
    return cache


def forward(params: Params, cfg: ModelConfig, tokens=None, embeds=None,
            cache: Optional[Params] = None, remat: str = "full",
            use_kernels: bool = True
            ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """-> (hidden (B,S,d), new_cache, aux_loss).

    Training: cache None.  Prefill: a zero-pos cache.  Decode: S == 1.
    aux_loss is 0 (no MoE block is ported).  `remat` ("none", "dots",
    "full") applies to a forward without a cache that autograd records."""
    require_supported(cfg)
    if embeds is None:
        embeds = params["embed"][tokens.long()]
    x = constrain(embeds, "dp", None, None)
    b, s, _ = x.shape
    dev = x.device

    cache_pos = cache["pos"] if cache is not None else None
    steps = torch.arange(s, device=dev)
    positions = steps if cache is None else cache_pos[:, None] + steps[None]
    hd_rot = rope_dims(cfg.hd, cfg.rope_pct)
    rope = rope_tables(positions, hd_rot, cfg.rope_theta) if hd_rot else None
    index = None
    if cache is not None:
        s_max = cache["layers"][0]["kv"]["k"].shape[1] \
            if cache["layers"] else 0
        index = cache_index(cache_pos, s_max, s, use_kernels)

    remat_kw = _remat_kwargs(remat)
    if cache is not None or not torch.is_grad_enabled():
        remat_kw = None

    def train_block(p, x):
        return apply_block(p, cfg, x, positions, None, None, rope=rope,
                           use_kernels=use_kernels)[0]

    new_layers = []
    for i, p in enumerate(params["layers"]):
        if remat_kw is not None:
            x = checkpoint(train_block, p, x, **remat_kw)
            continue
        blk_cache = cache["layers"][i] if cache is not None else None
        x, nc = apply_block(p, cfg, x, positions, blk_cache, cache_pos,
                            index=index, rope=rope, use_kernels=use_kernels)
        new_layers.append(nc)

    x = apply_norm(params["final_norm"], x)
    new_cache = None
    if cache is not None:
        new_cache = {"layers": new_layers, "pos": cache_pos + s}
    return x, new_cache, torch.zeros((), dtype=torch.float32, device=dev)


def head_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


# ---------------------------------------------------------------------------
# Task-level entry points
# ---------------------------------------------------------------------------

def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            remat: str = "full", use_kernels: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy, differentiable by autograd with
    `use_kernels=False` (the plain attention, which the reference's
    training path runs).  The attention kernels have no backward: with
    `use_kernels=True` a loss whose parameters require grad raises."""
    x, _, aux = forward(params, cfg, tokens=batch.get("tokens"),
                        embeds=batch.get("embeds"), remat=remat,
                        use_kernels=use_kernels)
    return lm_loss(head_matrix(params, cfg), x, batch["labels"]) + aux


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            max_len: int, use_kernels: bool = True
            ) -> Tuple[torch.Tensor, Params]:
    """Run the prompt, build the cache, return last-position logits."""
    tokens = batch.get("tokens")
    embeds = batch.get("embeds")
    src = tokens if tokens is not None else embeds
    cache = init_cache(cfg, src.shape[0], max_len, device=src.device)
    x, new_cache, _ = forward(params, cfg, tokens=tokens, embeds=embeds,
                              cache=cache, remat="none",
                              use_kernels=use_kernels)
    logits = x[:, -1:, :] @ head_matrix(params, cfg)
    return logits, new_cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, use_kernels: bool = True
                ) -> Tuple[torch.Tensor, Params]:
    """tokens: (B, 1) -> (logits (B,1,V), new_cache)."""
    x, new_cache, _ = forward(params, cfg, tokens=tokens, cache=cache,
                              remat="none", use_kernels=use_kernels)
    logits = x @ head_matrix(params, cfg)
    return logits, new_cache
