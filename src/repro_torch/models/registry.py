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
(`train.loop` does).

`input_specs(cfg, shape)` returns stand-ins for every input of the step
that the dry-run traces: fake tensors (`fake_mode()`, shapes and dtypes
on the CPU, no storage), the counterpart of the reference's
`ShapeDtypeStruct`s, in the reference's layouts (a decoder's cache
stacked as `convert.cache_to_reference` stacks it).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
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
# Input specs for the dry-run (fake tensors, no allocation)
# ---------------------------------------------------------------------------

_FAKE = []


def fake_mode():
    """The process's one `FakeTensorMode`: tensors made under it have
    shapes, dtypes and a CPU device and no storage.  Every stand-in of a
    step -- parameters, optimizer state, inputs -- is made under this one
    mode, since fake tensors of two modes do not mix."""
    if not _FAKE:
        from torch._subclasses.fake_tensor import FakeTensorMode
        _FAKE.append(FakeTensorMode(allow_non_fake_inputs=True))
    return _FAKE[0]


def _tok(shape):
    return torch.empty(shape, dtype=torch.int32)


def _embeds(cfg: ModelConfig, b: int, s: int):
    return torch.empty((b, s, cfg.d_model), dtype=dtype_of(cfg))


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    with fake_mode():
        if cfg.is_encdec:
            return {"frames": _embeds(cfg, b, s),
                    "tokens": _tok((b, cfg.decoder_len)),
                    "labels": _tok((b, cfg.decoder_len))}
        if cfg.family == "vlm":
            # early-fusion VLM: the VQ tokenizer frontend is a stub; the
            # inputs are precomputed patch-token embeddings
            return {"embeds": _embeds(cfg, b, s), "labels": _tok((b, s))}
        return {"tokens": _tok((b, s)), "labels": _tok((b, s))}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig
                        ) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    with fake_mode():
        if cfg.is_encdec:
            return {"frames": _embeds(cfg, b, s),
                    "tokens": _tok((b, cfg.decoder_len))}
        if cfg.family == "vlm":
            return {"embeds": _embeds(cfg, b, s)}
        return {"tokens": _tok((b, s))}


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Dict[str, Any]:
    """Specs for (cache, tokens) of one serve_step with a seq_len-long
    context already in the cache."""
    from .convert import cache_to_reference
    b, s = shape.global_batch, shape.seq_len
    with fake_mode():
        if cfg.is_encdec:
            cache = whisper.init_cache(cfg, b, cfg.decoder_len,
                                       _embeds(cfg, b, s))
        else:
            cache = cache_to_reference(
                transformer.init_cache(cfg, b, s, "cpu"), cfg)
        return {"cache": cache, "tokens": _tok((b, 1))}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)


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
