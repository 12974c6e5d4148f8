"""Whisper-style encoder-decoder (audio backbone, conv frontend stubbed):
the counterpart of `repro.models.whisper`.

As in the reference, the modality frontend is a stub: callers give
precomputed frame embeddings (B, S_audio, d_model), as if the two conv
layers had already run.  The backbone: sinusoidal encoder positions,
learned decoder positions (read at positions clamped to decoder_len - 1,
the reference's `mode="clip"`), pre-LN blocks, GELU MLPs, a decoder with
causal self-attention and cross-attention over the encoder's states.

Parameters are {'tok_embed', 'dec_pos', 'enc_norm', 'dec_norm',
'enc_layers', 'dec_layers'}: the reference's `enc_stack` / `dec_stack`
as plain lists of per-layer blocks (`convert.py` carries them across).
The cache is the reference's tree: {'kv_stack': {'kv': {'k', 'v'}}}, each
(n_layers, B, max_len, KVH, hd) and written IN PLACE through per-layer
views, with 'pos' (B,) and 'enc_out'.  A decode step recomputes every
layer's cross K/V from `enc_out`, as the reference does.

Each forward function takes `use_kernels=` (`models.common`): the
encoder and a prompt's self- and cross-attention run the flash kernel,
a decode step's self-attention the paged kernel over the dense cache and
its cross-attention the paged kernel over the step's cross K/V.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.api import constrain
from .common import (apply_attention, apply_mlp, apply_norm, cache_index,
                     dtype_of, embed_init, init_attention, init_mlp,
                     init_norm, kv_index, lm_loss)

Params = Dict[str, Any]


def require_encdec(cfg: ModelConfig) -> None:
    if not cfg.is_encdec:
        raise ValueError(f"{cfg.name}: not an encoder-decoder config; its "
                         "entry points are models.transformer's")


def sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) float32: the reference's table, computed in numpy as
    it is and rounded once."""
    half = d // 2
    log_timescale = np.log(10000.0) / (half - 1)
    inv = np.exp(-log_timescale * np.arange(half))
    scaled = np.arange(length)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def init_enc_block(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {"norm1": init_norm(cfg, device),
            "attn": init_attention(gen, cfg, device),
            "norm2": init_norm(cfg, device),
            "mlp": init_mlp(gen, cfg, device)}


def init_dec_block(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    return {"norm1": init_norm(cfg, device),
            "self_attn": init_attention(gen, cfg, device),
            "norm_x": init_norm(cfg, device),
            "cross_attn": init_attention(gen, cfg, device),
            "norm2": init_norm(cfg, device),
            "mlp": init_mlp(gen, cfg, device)}


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig,
                device=None) -> Params:
    """Seeded parameters on `device` (None = the card), drawn from `gen`
    (a generator on that device; None = seed 0).  Not the reference's
    threefry stream: carry its parameters across with
    `convert.params_from_reference`."""
    require_encdec(cfg)
    dev = resolve_device(device)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    dt = dtype_of(cfg)
    enc = [init_enc_block(gen, cfg, dev)
           for _ in range(cfg.n_encoder_layers)]
    dec = [init_dec_block(gen, cfg, dev) for _ in range(cfg.n_layers)]
    return {"tok_embed": embed_init(gen, cfg.vocab, cfg.d_model, dt, dev),
            "dec_pos": embed_init(gen, cfg.decoder_len, cfg.d_model, dt,
                                  dev),
            "enc_norm": init_norm(cfg, dev), "dec_norm": init_norm(cfg, dev),
            "enc_layers": enc, "dec_layers": dec}


def _remat(remat: str) -> bool:
    """The reference's rule: "full" recomputes each layer in the backward
    pass (`torch.utils.checkpoint`, its `nothing_saveable` checkpoint),
    any other value saves everything.  Only a forward that autograd
    records checkpoints."""
    return remat == "full" and torch.is_grad_enabled()


def encode(params: Params, cfg: ModelConfig, frames: torch.Tensor,
           remat: str = "full", use_kernels: bool = True) -> torch.Tensor:
    """frames: (B, S_audio, d) stub embeddings -> encoder states."""
    s = frames.shape[1]
    x = frames + sinusoids(s, cfg.d_model, frames.device).to(frames.dtype)
    x = constrain(x, "dp", None, None)
    positions = torch.arange(s, device=frames.device)

    def block(p, x):
        h = apply_norm(p["norm1"], x)
        out, _ = apply_attention(p["attn"], cfg, h, positions, causal=False,
                                 use_kernels=use_kernels)
        x = x + out
        x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["norm2"], x))
        return constrain(x, "dp", None, None)

    full = _remat(remat)
    for p in params["enc_layers"]:
        x = checkpoint(block, p, x, use_reentrant=False) if full \
            else block(p, x)
    return apply_norm(params["enc_norm"], x)


def decode(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           enc_out: torch.Tensor, cache: Optional[Params] = None,
           remat: str = "full", use_kernels: bool = True,
           cache_start: Optional[int] = None
           ) -> Tuple[torch.Tensor, Optional[Params]]:
    """tokens: (B, T) -> (hidden (B, T, d), new_cache).  cache: the
    per-layer stacked self K/V (`init_cache`), written in place;
    `cache_start`: where a multi-token call writes it, when the caller
    knows it (`cache_index`)."""
    b, t = tokens.shape
    dev = tokens.device
    cache_pos = cache["pos"] if cache is not None else None
    steps = torch.arange(t, device=dev)
    positions = steps if cache is None else cache_pos[:, None] + steps[None]
    x = params["tok_embed"][tokens.long()]
    x = x + params["dec_pos"][positions.long().clamp(0, cfg.decoder_len - 1)]
    x = constrain(x, "dp", None, None)

    index = cross = None
    if cache is not None:
        ks, vs = cache["kv_stack"]["kv"]["k"], cache["kv_stack"]["kv"]["v"]
        index = cache_index(cache_pos, ks.shape[2], t, use_kernels,
                            cache_start)
    if use_kernels and t == 1:
        cross = kv_index(b, enc_out.shape[1], dev)

    def block(p, x, kv):
        h = apply_norm(p["norm1"], x)
        out, _ = apply_attention(p["self_attn"], cfg, h, positions,
                                 cache=kv, cache_pos=cache_pos, index=index,
                                 use_kernels=use_kernels)
        x = x + out
        hx = apply_norm(p["norm_x"], x)
        out, _ = apply_attention(p["cross_attn"], cfg, hx, positions,
                                 kv_x=enc_out, causal=False, index=cross,
                                 use_kernels=use_kernels)
        x = x + out
        x = x + apply_mlp(p["mlp"], cfg, apply_norm(p["norm2"], x))
        return constrain(x, "dp", None, None)

    full = cache is None and _remat(remat)
    for i, p in enumerate(params["dec_layers"]):
        if full:
            x = checkpoint(block, p, x, None, use_reentrant=False)
        else:
            kv = None if cache is None else {"k": ks[i], "v": vs[i]}
            x = block(p, x, kv)
    new_cache = None
    if cache is not None:
        new_cache = {"kv_stack": cache["kv_stack"], "pos": cache_pos + t,
                     "enc_out": cache["enc_out"]}
    return apply_norm(params["dec_norm"], x), new_cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               enc_out: torch.Tensor) -> Params:
    """Zero self K/V on `enc_out`'s device, positions 0."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = enc_out.device
    return {"kv_stack": {"kv": {
        "k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
        "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev)}},
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "enc_out": enc_out}


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            remat: str = "full", use_kernels: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of the decoder over the encoded
    frames; differentiable with `use_kernels=False` (the attention
    kernels have no backward)."""
    enc_out = encode(params, cfg, batch["frames"], remat=remat,
                     use_kernels=use_kernels)
    x, _ = decode(params, cfg, batch["tokens"], enc_out, remat=remat,
                  use_kernels=use_kernels)
    return lm_loss(params["tok_embed"].T, x, batch["labels"])


def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            max_len: int, use_kernels: bool = True
            ) -> Tuple[torch.Tensor, Params]:
    """Encode the frames, run the prompt tokens into a fresh cache and
    return the last position's logits (B, 1, V)."""
    enc_out = encode(params, cfg, batch["frames"], remat="none",
                     use_kernels=use_kernels)
    cache = init_cache(cfg, batch["tokens"].shape[0], max_len, enc_out)
    x, new_cache = decode(params, cfg, batch["tokens"], enc_out, cache=cache,
                          remat="none", use_kernels=use_kernels,
                          cache_start=0)
    return x[:, -1:, :] @ params["tok_embed"].T, new_cache


def decode_step(params: Params, cfg: ModelConfig, cache: Params,
                tokens: torch.Tensor, use_kernels: bool = True
                ) -> Tuple[torch.Tensor, Params]:
    """tokens: (B, 1) -> (logits (B, 1, V), new_cache)."""
    x, new_cache = decode(params, cfg, tokens, cache["enc_out"], cache=cache,
                          remat="none", use_kernels=use_kernels)
    return x @ params["tok_embed"].T, new_cache
