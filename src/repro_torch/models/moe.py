"""Mixture-of-Experts layer with sorted dispatch: the counterpart of
`repro.models.moe`.

The token->expert assignment is an unstructured sparse operator (the
R-MAT case); sorting the token slots by expert id makes the dispatch
block-diagonal (the FD case), and the experts run as dense batched
GEMMs over (E, cap, d) buffers.  `dispatch_structure_demo` builds both
matrices as CSR so `core.structure.analyze` can measure the change.

What the routing matches in the reference, decision for decision:
  * top-k keeps the k largest probabilities, ties to the lower expert
    index (`jax.lax.top_k`): a stable descending sort, not `torch.topk`,
    whose tie order is unspecified on CUDA;
  * slots are sorted by expert with a stable sort (`jnp.argsort`), so
    within an expert earlier tokens take the capacity first;
  * cap = int(ceil(T·k / E) · capacity_factor): a decode step of 8 slots
    at k = 2, E = 16 has cap 1, and a second token for an expert is
    dropped (it goes to the overflow row E·cap and adds nothing);
  * the combine adds each token's kept contributions in x's dtype in the
    order of the sorted slots (ascending expert id), as the reference's
    scatter-add does, by k gathers: no atomics, so a replay is
    bit-identical on the card.

The expert GEMMs are `torch.bmm` (the reference computes them outside
any Pallas kernel).  The reference's mesh paths (`apply_moe_sharded`,
`apply_moe_a2a`, `apply_moe_decode`) wait for the distributed slice;
with no mesh `apply_moe_auto` is `apply_moe`, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import constrain
from .common import dense_init, dtype_of

Params = Dict[str, Any]

_MESH_PATHS = ("ROADMAP A11, slice 3c (distributed): the port has no "
               "mesh; apply_moe_auto runs apply_moe")


def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_expert_ff, m.n_experts
    dt = dtype_of(cfg)
    p = {
        "router": dense_init(gen, d, e, torch.float32, device, scale=0.02),
        "w_gate": dense_init(gen, e * d, ff, dt, device).reshape(e, d, ff),
        "w_up": dense_init(gen, e * d, ff, dt, device).reshape(e, d, ff),
        "w_down": dense_init(gen, e * ff, d, dt, device).reshape(e, ff, d),
    }
    if m.n_shared_experts:
        se = m.n_shared_experts
        p["shared_gate"] = dense_init(gen, se * d, ff, dt,
                                      device).reshape(se, d, ff)
        p["shared_up"] = dense_init(gen, se * d, ff, dt,
                                    device).reshape(se, d, ff)
        p["shared_down"] = dense_init(gen, se * ff, d, dt,
                                      device).reshape(se, ff, d)
    return p


@dataclasses.dataclass(frozen=True)
class Routing:
    """One call's routing, in the reference's names: `top_w`, `top_e`
    (T, k); `order` the stable sort of the flat slots by expert, and in
    that order `se`, `sw`, `st` (expert, weight, token), `pos_in_e`,
    `keep` and `slot` (E·cap for a dropped slot)."""
    top_w: torch.Tensor
    top_e: torch.Tensor
    order: torch.Tensor
    se: torch.Tensor
    sw: torch.Tensor
    st: torch.Tensor
    pos_in_e: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    cap: int


def capacity_for(cfg: ModelConfig, t: int,
                 capacity: Optional[int] = None) -> int:
    m = cfg.moe
    return capacity or int(-(-t * m.top_k // m.n_experts)
                           * m.capacity_factor)


def route(probs: torch.Tensor, k: int, cap: int) -> Routing:
    """probs: (T, E) float32 router probabilities -> the routing."""
    t, e = probs.shape
    # jax.lax.top_k: descending, ties to the lower index
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :k], top_e[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)        # the permutation
    se = flat_e[order]
    sw = top_w.reshape(-1)[order]
    st = torch.div(order, k, rounding_mode="floor")   # repeat(arange(T), k)
    pos_in_e = torch.arange(t * k, device=probs.device) \
        - torch.searchsorted(se, se, side="left")
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e * cap))
    return Routing(top_w, top_e, order, se, sw, st, pos_in_e, keep, slot,
                   cap)


def aux_losses(cfg: ModelConfig, logits: torch.Tensor, probs: torch.Tensor,
               top_e: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Load balance and router z-loss, the reference's formulas."""
    m = cfg.moe
    t, e = probs.shape
    me = probs.mean(dim=0)
    ce = torch.bincount(top_e.reshape(-1), minlength=e).float() \
        * (1.0 / (t * m.top_k))
    return {"moe_balance": e * torch.sum(me * ce) * m.aux_loss_weight,
            "moe_zloss": (torch.logsumexp(logits, dim=-1) ** 2).mean()
            * m.router_z_loss}


def combine_order(r: Routing, t: int) -> torch.Tensor:
    """(T, k): each token's positions in the sorted slots, ascending --
    the order the reference's scatter-add visits them in."""
    k = r.top_e.shape[1]
    rank = torch.empty_like(r.order)
    rank[r.order] = torch.arange(r.order.numel(), device=r.order.device)
    return rank.view(t, k).sort(dim=1).values


def apply_moe(p: Params, cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (y, aux_losses).

    Sorted dispatch with a fixed expert capacity (dropped tokens pass
    through the residual only)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    xt = x.reshape(t, d)

    logits = xt.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    r = route(probs, k, capacity_for(cfg, t, capacity))
    aux = aux_losses(cfg, logits, probs, r.top_e)
    cap = r.cap

    # dispatch: the kept slots' tokens into an (E·cap, d) buffer
    kept = r.slot[r.keep]
    buf = xt.new_zeros((e * cap, d)).index_put((kept,), xt[r.st[r.keep]])
    buf = constrain(buf.view(e, cap, d), "model", "dp", None)

    # expert FFNs: dense per-expert GEMMs (the block-diagonal multiply)
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out = constrain(torch.bmm(h, p["w_down"]), "model", "dp", None)

    # combine: weighted, in x's dtype, each token's slots in sorted order
    out_flat = out.reshape(e * cap, d)
    gathered = torch.where(r.keep[:, None],
                           out_flat[r.slot.clamp(max=e * cap - 1)],
                           out_flat.new_zeros(()))
    contrib = (gathered * r.sw[:, None]).to(x.dtype)         # sorted slots
    y = xt.new_zeros((t, d))
    for j in combine_order(r, t).unbind(1):
        y = y + contrib[j]

    # shared experts (Kimi K2): always on, added to every token
    if m.n_shared_experts:
        hs = torch.einsum("td,edf->etf", xt, p["shared_gate"])
        hs = F.silu(hs) * torch.einsum("td,edf->etf", xt, p["shared_up"])
        y = y + torch.einsum("etf,efd->td", hs,
                             p["shared_down"]).to(x.dtype)
    return y.reshape(b, s, d), aux


def apply_moe_sharded(p: Params, cfg: ModelConfig, x: torch.Tensor):
    raise NotImplementedError(f"apply_moe_sharded: {_MESH_PATHS}")


def apply_moe_a2a(p: Params, cfg: ModelConfig, x: torch.Tensor):
    raise NotImplementedError(f"apply_moe_a2a: {_MESH_PATHS}")


def apply_moe_decode(p: Params, cfg: ModelConfig, x: torch.Tensor):
    raise NotImplementedError(f"apply_moe_decode: {_MESH_PATHS}")


def apply_moe_auto(p: Params, cfg: ModelConfig, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's router between the global path and its mesh
    paths: no mesh is ever active in the port, so the global path."""
    return apply_moe(p, cfg, x)


def dispatch_structure_demo(top_e, n_experts: int, device=None):
    """The (T, E) assignment matrix before sorting and the (T·k, E) one
    after, as CSR (`core.formats.CSR`) on `device` (None = the card)."""
    from repro_torch.core.formats import CSR

    top_e = np.asarray(top_e.cpu() if isinstance(top_e, torch.Tensor)
                       else top_e)
    t, k = top_e.shape
    rows = np.repeat(np.arange(t), k)
    cols = top_e.reshape(-1)
    vals = np.ones(t * k, np.float32)
    unsorted = CSR.from_coo(rows, cols, vals, t, n_experts, device=device)
    order = np.argsort(cols, kind="stable")
    sorted_m = CSR.from_coo(np.arange(t * k), cols[order], vals, t * k,
                            n_experts, device=device)
    return unsorted, sorted_m
