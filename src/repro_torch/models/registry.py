"""Uniform model API: the counterpart of `repro.models.registry`.

    api = get_model(cfg)
    params = api.init(generator, device)
    loss   = api.loss_fn(params, batch, remat="none", use_kernels=False)
    logits, cache = api.prefill(params, batch, max_len)
    logits, cache = api.decode_step(params, cache, tokens)

An encoder-decoder config (`is_encdec`) gets `models.whisper`'s
functions, every other config `models.transformer`'s.  Each function
takes `use_kernels=` (default True: flash attention for prompts, paged
attention for decode steps).  The kernels have no
backward, so training differentiates `loss_fn` with `use_kernels=False`
(`train.loop` does).  The reference's
`input_specs` family serves its multi-pod dry-run and waits for the
port's `launch/dryrun` (ROADMAP A11, slice 3d).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from . import transformer, whisper
from .common import dtype_of

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable
    loss_fn: Callable
    prefill: Callable
    decode_step: Callable


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.is_encdec:
        return ModelAPI(
            cfg=cfg,
            init=lambda gen=None, device=None: whisper.init_params(
                gen, cfg, device),
            loss_fn=functools.partial(_flip(whisper.loss_fn), cfg),
            prefill=functools.partial(_flip(whisper.prefill), cfg),
            decode_step=functools.partial(_flip(whisper.decode_step), cfg),
        )
    return ModelAPI(
        cfg=cfg,
        init=lambda gen=None, device=None: transformer.init_params(
            gen, cfg, device),
        loss_fn=functools.partial(_flip(transformer.loss_fn), cfg),
        prefill=functools.partial(_flip(transformer.prefill), cfg),
        decode_step=functools.partial(_flip(transformer.decode_step), cfg),
    )


def _flip(fn):
    """(params, cfg, ...) -> (cfg, params, ...) for partial application."""
    def wrapped(cfg, params, *a, **k):
        return fn(params, cfg, *a, **k)
    return wrapped


# ---------------------------------------------------------------------------
# Random batches for smoke tests / examples (reduced configs only)
# ---------------------------------------------------------------------------

def random_train_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                       device=None) -> Dict[str, torch.Tensor]:
    """The reference's batch: the same numpy draws, as tensors on
    `device` (None = the card).  An encoder-decoder's: `seq` frames of
    embeddings, then tokens and labels of max(1, min(seq, decoder_len -
    8)) tokens."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def ints(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(
            np.int32)).to(dev)

    def embeds():
        e = rng.normal(size=(batch, seq, cfg.d_model)).astype(np.float32)
        return torch.from_numpy(e).to(dev, dtype_of(cfg))

    if cfg.is_encdec:
        t = max(1, min(seq, cfg.decoder_len - 8))
        frames = embeds()
        return {"frames": frames, "tokens": ints((batch, t)),
                "labels": ints((batch, t))}
    if cfg.family == "vlm":
        return {"embeds": embeds(), "labels": ints((batch, seq))}
    return {"tokens": ints((batch, seq)), "labels": ints((batch, seq))}
