"""Optimizers on trees of tensors: AdamW and factored Adafactor, the
counterpart of `repro.optim.adamw`.

AdamW keeps two float32 moments (8 bytes a parameter beside the
parameters); Adafactor a factored second moment in bfloat16
accumulators, for the configs whose AdamW state does not fit
(`launch.steps.optimizer_for`).

The arithmetic is the reference's, in its order and types: gradients
are clipped to the global norm in their own dtype, then upcast; moments,
updates and the parameter step run in float32 and are rounded once to
the parameter's dtype; weight decay applies to leaves of two or more
dims.  Updates write the parameters and the state's tensors in place
(the reference donates them) and return the same trees.

The step counter lives on the host (a 0-d int32 CPU tensor), and the
scalars derived from it -- the learning rate, the bias corrections and
Adafactor's decay -- are float32 host scalars, as JAX computes them:
IEEE float32 arithmetic, with `cos` and `pow` from the C library's
`cosf` / `powf`, which XLA's CPU backend calls.  So `cosine_lr` is
the reference's bit for bit.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map

Params = Any
F32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # schedule
    warmup_steps: int = 2000
    total_steps: int = 100_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Params
    nu: Params


class AdafactorState(NamedTuple):
    step: torch.Tensor
    # per-leaf: either (row, col) factored stats or a full `nu` for <2D
    vr: Params
    vc: Params
    v_full: Params


@functools.cache
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.restype = ctypes.c_float
    lib.cosf.argtypes = [ctypes.c_float]
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


def _cosf(x) -> np.float32:
    return F32(_libm().cosf(float(x)))


def _powf(x, y) -> np.float32:
    return F32(_libm().powf(float(x), float(y)))


def _lr(cfg: OptimizerConfig, step: int) -> np.float32:
    """The schedule at `step` in float32, operation for operation."""
    warm = min(F32(step) / F32(max(cfg.warmup_steps, 1)), F32(1.0))
    prog = np.clip(F32(step - cfg.warmup_steps)
                   / F32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   F32(0.0), F32(1.0))
    cos = F32(0.5) * (F32(1.0) + _cosf(F32(np.pi) * prog))
    frac = F32(cfg.min_lr_frac) + F32(1 - cfg.min_lr_frac) * cos
    return F32(cfg.lr) * warm * frac


def cosine_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to `min_lr_frac`: a 0-d float32
    CPU tensor, equal bit for bit to the reference's."""
    return torch.tensor(_lr(cfg, int(step)), dtype=torch.float32)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The reference's `(g * scale).astype(g.dtype)`: JAX multiplies a
    bfloat16 g by the float32 scale in float32."""
    return (g.float() * scale).to(g.dtype)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: _clipped(g, scale), tree), norm


def _zeros(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device)


def _step0() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw_init(params: Params) -> AdamWState:
    zeros = lambda p: _zeros(p.shape, torch.float32, p)  # noqa: E731
    return AdamWState(step=_step0(), mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params))


def adamw_update(cfg: OptimizerConfig, grads: Params, state: AdamWState,
                 params: Params, norm_fn=global_norm
                 ) -> Tuple[Params, AdamWState, dict]:
    norm = norm_fn(grads)
    scale = _clip_scale(norm, cfg.grad_clip)
    step = int(state.step) + 1
    lr = float(_lr(cfg, step))
    bc1 = float(F32(1.0) - _powf(F32(cfg.b1), F32(step)))
    bc2 = float(F32(1.0) - _powf(F32(cfg.b2), F32(step)))
    b1, b2 = cfg.b1, cfg.b2
    with torch.no_grad():
        for g, m, v, p in zip(leaves(grads), leaves(state.mu),
                              leaves(state.nu), leaves(params)):
            gf = _clipped(g, scale).float()
            m.mul_(b1).add_(gf * (1 - b1))
            v.mul_(b2).add_(gf * (1 - b2) * gf)
            delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
            if p.ndim >= 2:   # decoupled weight decay on matrices only
                delta.add_(cfg.weight_decay * p.float())
            p.copy_(p.float() - delta.mul_(lr))
    metrics = {"grad_norm": norm, "lr": torch.tensor(lr, dtype=torch.float32)}
    return params, AdamWState(torch.tensor(step, dtype=torch.int32),
                              state.mu, state.nu), metrics


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, bf16 accumulators)
# ---------------------------------------------------------------------------

def adafactor_init(params: Params) -> AdafactorState:
    bf16 = torch.bfloat16

    def vr(p):
        return _zeros(p.shape[:-1] if p.ndim >= 2 else (), bf16, p)

    def vc(p):
        return _zeros(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (),
                      bf16, p)

    def vf(p):
        return _zeros(() if p.ndim >= 2 else p.shape, bf16, p)

    return AdafactorState(step=_step0(), vr=tree_map(vr, params),
                          vc=tree_map(vc, params),
                          v_full=tree_map(vf, params))


def adafactor_update(cfg: OptimizerConfig, grads: Params,
                     state: AdafactorState, params: Params
                     ) -> Tuple[Params, AdafactorState, dict]:
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.grad_clip)
    step = int(state.step) + 1
    lr = float(_lr(cfg, step))
    decay = F32(1.0) - _powf(F32(step + 1), F32(-0.8))
    keep, take = float(decay), float(F32(1.0) - decay)
    with torch.no_grad():
        for g, vr, vc, vf, p in zip(leaves(grads), leaves(state.vr),
                                    leaves(state.vc), leaves(state.v_full),
                                    leaves(params)):
            gf = _clipped(g, scale).float()
            g2 = gf * gf + 1e-30
            if p.ndim >= 2:
                vr2 = keep * vr.float() + take * g2.mean(-1)
                vc2 = keep * vc.float() + take * g2.mean(-2)
                denom = (vr2[..., None] * vc2[..., None, :]
                         / torch.clamp(vr2.mean(-1)[..., None, None],
                                       min=1e-30))
                delta = gf / (denom.sqrt_() + cfg.eps)
                vr.copy_(vr2)
                vc.copy_(vc2)
            else:
                vf2 = keep * vf.float() + take * g2
                delta = gf / (vf2.sqrt() + cfg.eps)
                vf.copy_(vf2)
            # update clipping (Adafactor RMS rule)
            rms = torch.sqrt(torch.mean(delta * delta) + 1e-30)
            delta = delta / torch.clamp(rms, min=1.0)
            if p.ndim >= 2:
                delta.add_(cfg.weight_decay * p.float())
            p.copy_(p.float() - delta.mul_(lr))
    metrics = {"grad_norm": norm, "lr": torch.tensor(lr, dtype=torch.float32)}
    return params, AdafactorState(torch.tensor(step, dtype=torch.int32),
                                  state.vr, state.vc, state.v_full), metrics


# ---------------------------------------------------------------------------
# Uniform facade
# ---------------------------------------------------------------------------

def make_optimizer(cfg: OptimizerConfig, norm_fn=global_norm):
    """(init, update).  `norm_fn`: the gradient tree's global norm (the
    partitioned step's sums blocks over the mesh; AdamW only)."""
    if cfg.name == "adamw":
        return adamw_init, lambda g, s, p: adamw_update(cfg, g, s, p,
                                                        norm_fn)
    if norm_fn is not global_norm:
        raise NotImplementedError(
            f"{cfg.name} on blocks: its factored moments and update RMS "
            "span a whole leaf (ROADMAP A11, slice 3g)")
    if cfg.name == "adafactor":
        return adafactor_init, lambda g, s, p: adafactor_update(cfg, g, s, p)
    raise ValueError(cfg.name)


def optimizer_bytes_per_param(name: str) -> float:
    return {"adamw": 8.0, "adafactor": 2.1}[name]
