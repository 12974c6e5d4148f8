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
any Pallas kernel).

The mesh paths are the reference's `shard_map` bodies over a mesh
(`distributed.api`), line for line, with the same routing on each
shard's own tokens (so the capacity is the shard's: the mesh paths equal
`apply_moe` only when no slot drops):
  apply_moe_sharded  tokens split over dp, experts over 'model'; each
                     shard runs its experts' slots and a psum over
                     'model' combines (bf16 under `moe_combine_bf16`)
  apply_moe_a2a      tokens split over dp and 'model'; two all_to_alls
                     carry them to their experts' shard and back
  apply_moe_decode   tokens replicated; weights split over 'model' and
                     d over 'data' (partial GEMMs summed in float32)
`apply_moe_auto` picks one as the reference does (`models/tuning.py`'s
`moe_all_to_all` and `moe_decode_weight_stationary`).  Where the
reference scatter-adds expert rows into tokens, the port adds each
token's rows by gathers in the same order (no atomics); the rows of
empty slots, which the reference adds into token 0 with weight 0, add
their `out * 0` there last (a no-op unless an output is not finite).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.api import (P, all_gather, all_to_all,
                                         axis_index, constrain, current_mesh,
                                         mesh_dict, pmean, psum,
                                         resolve_axis, shard_map)
from . import tuning
from .common import dense_init, dtype_of

Params = Dict[str, Any]

#: calls of each mesh path (the smoke reads them around a model run)
CALLS: collections.Counter = collections.Counter()


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


def router_stats(cfg: ModelConfig, logits: torch.Tensor,
                 probs: torch.Tensor, top_e: torch.Tensor):
    """(mean router probability, routed fraction) of each expert and the
    mean squared logsumexp: what the aux losses are made of."""
    t, e = probs.shape
    me = probs.mean(dim=0)
    # each expert's routed slots, counted shape-statically (a one-hot
    # sum of integers: exact, and traceable without the data)
    hits = top_e.reshape(-1, 1) == torch.arange(e, device=top_e.device)
    ce = hits.sum(dim=0).float() * (1.0 / (t * cfg.moe.top_k))
    return me, ce, (torch.logsumexp(logits, dim=-1) ** 2).mean()


def aux_from(cfg: ModelConfig, me, ce, zloss) -> Dict[str, torch.Tensor]:
    m = cfg.moe
    return {"moe_balance": m.n_experts * torch.sum(me * ce)
            * m.aux_loss_weight,
            "moe_zloss": zloss * m.router_z_loss}


def aux_losses(cfg: ModelConfig, logits: torch.Tensor, probs: torch.Tensor,
               top_e: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Load balance and router z-loss, the reference's formulas."""
    return aux_from(cfg, *router_stats(cfg, logits, probs, top_e))


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

    # dispatch: the kept slots' tokens into an (E·cap, d) buffer; a
    # dropped slot writes the spare row E·cap, which is cut off (shapes
    # that do not depend on the routing)
    buf = xt.new_zeros((e * cap + 1, d)).index_put((r.slot,), xt[r.st])
    buf = constrain(buf[:e * cap].view(e, cap, d), "model", "dp", None)

    # expert FFNs: dense per-expert GEMMs (the block-diagonal multiply)
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out = constrain(torch.bmm(h, p["w_down"]), "model", "dp", None)

    # combine: weighted, in x's dtype, each token's slots in sorted order
    out_flat = out.reshape(e * cap, d)
    gathered = torch.where(r.keep[:, None],
                           out_flat[r.slot.clamp(max=e * cap - 1)],
                           out_flat.new_zeros(()))
    contrib = (gathered * r.sw[:, None]).to(x.dtype)         # sorted slots
    y = ordered_sum(contrib, combine_order(r, t))

    # shared experts (Kimi K2): always on, added to every token
    if m.n_shared_experts:
        y = y + shared_experts(p, xt).to(x.dtype)
    return y.reshape(b, s, d), aux


def ordered_sum(contrib: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """(T, d): row i is contrib[order[i, 0]] + contrib[order[i, 1]] + ...
    added in that order (a scatter-add's order, by gathers)."""
    y = contrib.new_zeros((order.shape[0], contrib.shape[1]))
    for j in order.unbind(1):
        y = y + contrib[j]
    return y


def shared_experts(p: Params, xt: torch.Tensor) -> torch.Tensor:
    """The always-on shared experts' sum for each token (Kimi K2)."""
    hs = torch.einsum("td,edf->etf", xt, p["shared_gate"])
    hs = F.silu(hs) * torch.einsum("td,edf->etf", xt, p["shared_up"])
    return torch.einsum("etf,efd->td", hs, p["shared_down"])


# ---------------------------------------------------------------------------
# Expert-parallel paths on a mesh (shard_map bodies)
# ---------------------------------------------------------------------------
#
# The global sorted scatter above is the reference semantics; on a mesh
# every data shard restructures ITS tokens locally (local sort -> local
# capacity), every model shard owns E/M experts and multiplies only its
# slice, and collectives over the mesh's axes recombine.

def _active_mesh(name: str):
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(f"{name} runs under use_mesh(mesh); no mesh is "
                           "active (apply_moe_auto takes apply_moe then)")
    return mesh


def _local_route(cfg: ModelConfig, xt: torch.Tensor, router: torch.Tensor):
    """A shard's (logits, probs, routing) of its own tokens, with the
    shard's own capacity (at least 1)."""
    logits = xt.float() @ router                            # (t, E)
    probs = torch.softmax(logits, dim=-1)
    cap = max(capacity_for(cfg, xt.shape[0]), 1)
    return logits, probs, route(probs, cfg.moe.top_k, cap)


def _pmean_over(v: torch.Tensor, axes) -> torch.Tensor:
    for ax in axes:
        v = pmean(v, ax)
    return v


def _expert_slots(r: Routing, e0: int, e_local: int):
    """The reference's slots of experts [e0, e0 + e_local): `in_range` and
    `slot` a sorted slot (e_local·cap where out of range or dropped), and
    `tok_buf` the token of each of the e_local·cap rows (0 where empty)."""
    cap = r.cap
    le = r.se - e0
    in_range = (le >= 0) & (le < e_local) & (r.pos_in_e < cap)
    slot = torch.where(in_range, le * cap + r.pos_in_e,
                       torch.full_like(le, e_local * cap))
    tok_buf = r.st.new_zeros(e_local * cap)
    tok_buf[slot[in_range]] = r.st[in_range]     # distinct rows: no race
    return in_range, slot, tok_buf


def _combine_rows(out: torch.Tensor, r: Routing, in_range: torch.Tensor,
                  slot: torch.Tensor, t: int) -> torch.Tensor:
    """`zeros((t, d), f32).at[tok_buf].add(out * wgt_buf[:, None])`: each
    token's in-range rows in slot order, then the empty rows' out · 0
    into token 0 (its value is unchanged unless such a row is not
    finite).  out: (rows, d) float32."""
    rows = out.shape[0]
    vals = torch.where(in_range[:, None],
                       out[slot.clamp(max=rows - 1)] * r.sw[:, None],
                       out.new_zeros(()))
    y = ordered_sum(vals, combine_order(r, t))
    empty = torch.ones(rows, dtype=torch.bool, device=out.device)
    empty[slot[in_range]] = False
    y[0] += (out[empty] * 0.0).sum(0)
    return y


def _with_shared(p: Params, cfg: ModelConfig, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    if cfg.moe.n_shared_experts:
        b, s, d = x.shape
        y = y + shared_experts(p, x.reshape(b * s, d)).to(x.dtype) \
            .reshape(b, s, d)
    return y


def apply_moe_sharded(p: Params, cfg: ModelConfig, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """shard_map MoE: per-data-shard dispatch, per-model-shard experts."""
    mesh = _active_mesh("apply_moe_sharded")
    CALLS["sharded"] += 1
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    dp = resolve_axis(mesh, "dp")
    n_model = mesh_dict(mesh)["model"]
    e_local = e // n_model

    def local_fn(xs, router, wg, wu, wd):
        # xs: (b_local, s, d); router: (d, E) replicated;
        # wg/wu/wd: (E/M, d, ff) local expert slice.
        bl = xs.shape[0]
        t = bl * s
        xt = xs.reshape(t, d)
        logits, probs, r = _local_route(cfg, xt, router)
        # aux losses from globally-averaged stats (pmean over dp)
        aux = aux_from(cfg, *(_pmean_over(v, dp) for v in
                              router_stats(cfg, logits, probs, r.top_e)))

        # this model shard's expert range
        j = axis_index("model")
        in_range, slot, tok_buf = _expert_slots(r, j * e_local, e_local)

        # gather only the local experts' rows: (E/M * cap, d)
        gx = xt[tok_buf].reshape(e_local, r.cap, d)
        h = F.silu(torch.bmm(gx, wg)) * torch.bmm(gx, wu)
        out = torch.bmm(h, wd).reshape(e_local * r.cap, d)

        y = _combine_rows(out.float(), r, in_range, slot, t)
        # combine across expert shards; bf16 halves the EP wire bytes
        if tuning.moe_combine_bf16:
            y = psum(y.to(torch.bfloat16), "model")
        else:
            y = psum(y, "model")
        return y.to(xs.dtype).reshape(bl, s, d), aux

    shard = shard_map(
        local_fn, mesh,
        in_specs=(P(dp, None, None), P(None, None),
                  P("model", None, None), P("model", None, None),
                  P("model", None, None)),
        out_specs=(P(dp, None, None),
                   {"moe_balance": P(), "moe_zloss": P()}))
    y, aux = shard(x, p["router"].float(), p["w_gate"], p["w_up"],
                   p["w_down"])
    return _with_shared(p, cfg, x, y), aux


def apply_moe_a2a(p: Params, cfg: ModelConfig, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """All-to-all expert parallelism: tokens stay sharded over every mesh
    axis (batch over dp, sequence over 'model'); one all_to_all sends
    each token to the model shard owning its expert, a second brings the
    outputs home."""
    mesh = _active_mesh("apply_moe_a2a")
    CALLS["a2a"] += 1
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    dp = resolve_axis(mesh, "dp")
    n_model = mesh_dict(mesh)["model"]
    e_local = e // n_model

    def local_fn(xs, router, wg, wu, wd):
        bl, sl = xs.shape[0], xs.shape[1]
        t = bl * sl
        xt = xs.reshape(t, d)
        logits, probs, r = _local_route(cfg, xt, router)
        aux = aux_from(cfg, *(_pmean_over(v, dp + ("model",)) for v in
                              router_stats(cfg, logits, probs, r.top_e)))

        # local restructure: MY slots sorted by (global) expert id
        cap = r.cap
        send = xt.new_zeros((e * cap, d))
        send[r.slot[r.keep]] = xt[r.st[r.keep]]
        send = send.reshape(n_model, e_local * cap, d)
        recv = all_to_all(send, "model")
        # recv[src] = tokens from member `src` for MY experts:
        # (M, e_local, cap, d) -> (e_local, M*cap, d)
        gx = recv.reshape(n_model, e_local, cap, d) \
            .transpose(0, 1).reshape(e_local, n_model * cap, d)
        h = F.silu(torch.bmm(gx, wg)) * torch.bmm(gx, wu)
        out = torch.bmm(h, wd)
        # back to (M, e_local*cap, d) source-major, return home
        out = out.reshape(e_local, n_model, cap, d) \
            .transpose(0, 1).reshape(n_model, e_local * cap, d)
        back = all_to_all(out, "model")
        # back[j] = outputs from expert shard j for MY tokens, laid out in
        # global-expert-major order == the `slot` indexing above
        back = back.reshape(e * cap, d)
        gathered = torch.where(r.keep[:, None],
                               back[r.slot.clamp(max=e * cap - 1)],
                               back.new_zeros(()))
        y = ordered_sum(gathered.float() * r.sw[:, None],
                        combine_order(r, t))
        return y.to(xs.dtype).reshape(bl, sl, d), aux

    shard = shard_map(
        local_fn, mesh,
        in_specs=(P(dp, "model", None), P(None, None),
                  P("model", None, None), P("model", None, None),
                  P("model", None, None)),
        out_specs=(P(dp, "model", None),
                   {"moe_balance": P(), "moe_zloss": P()}))
    y, aux = shard(x, p["router"].float(), p["w_gate"], p["w_up"],
                   p["w_down"])
    return _with_shared(p, cfg, x, y), aux


def apply_moe_decode(p: Params, cfg: ModelConfig, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weight-stationary MoE for decode-sized token counts: the weights
    stay in their (model, data) blocks; each member computes partial
    GEMMs on its d-slice and the sums run over activations."""
    mesh = _active_mesh("apply_moe_decode")
    CALLS["decode"] += 1
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    shape = mesh_dict(mesh)
    n_model, n_data = shape["model"], shape["data"]
    e_local = e // n_model
    d_local = d // n_data

    def local_fn(xs, router, wg, wu, wd):
        # xs is the FULL (replicated) token set, which lets the
        # d-contraction split over 'data'
        bl = xs.shape[0]
        t = bl * s
        xt = xs.reshape(t, d)
        logits, probs, r = _local_route(cfg, xt, router)
        zero = torch.zeros((), dtype=torch.float32, device=xs.device)
        aux = {"moe_balance": zero, "moe_zloss": zero.clone()}

        j = axis_index("model")
        in_range, slot, tok_buf = _expert_slots(r, j * e_local, e_local)
        cap = r.cap
        gx = xt[tok_buf]                                 # (E/M*cap, d)
        i = axis_index("data")
        gxs = gx[:, i * d_local:(i + 1) * d_local] \
            .reshape(e_local, cap, d_local)
        # f32 partials: the d-contraction is split across 'data' shards
        hg = psum(_bmm_f32(gxs, wg), "data")
        hu = psum(_bmm_f32(gxs, wu), "data")
        hmid = F.silu(hg) * hu                           # (E/M, cap, ff)
        out_p = _bmm_f32(hmid, wd)                       # (E/M, cap, d/D)
        out = all_gather(out_p, "data", axis=2, tiled=True)
        out = out.reshape(e_local * cap, d)
        y = _combine_rows(out, r, in_range, slot, t)
        y = psum(y.to(torch.bfloat16), "model")
        return y.to(xs.dtype).reshape(bl, s, d), aux

    shard = shard_map(
        local_fn, mesh,
        in_specs=(P(None, None, None), P(None, None),
                  P("model", "data", None), P("model", "data", None),
                  P("model", None, "data")),
        out_specs=(P(None, None, None),
                   {"moe_balance": P(), "moe_zloss": P()}))
    y, aux = shard(x, p["router"].float(), p["w_gate"], p["w_up"],
                   p["w_down"])
    return _with_shared(p, cfg, x, y), aux


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch.bmm` of a and b widened to float32 (exactly, from bf16): the
    reference's einsum with a float32 result.  One expert's block is
    widened at a time, so a rank never holds a float32 copy of its
    whole weight blocks."""
    out = torch.empty(a.shape[0], a.shape[1], b.shape[2],
                      dtype=torch.float32, device=a.device)
    for j in range(a.shape[0]):
        torch.mm(a[j].float(), b[j].float(), out=out[j])
    return out


def apply_moe_auto(p: Params, cfg: ModelConfig, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Route to a mesh path when a model-axis mesh is active and the
    expert count divides it; otherwise the global reference path."""
    mesh = current_mesh()
    if mesh is None:
        return apply_moe(p, cfg, x)
    shape = mesh_dict(mesh)
    if "model" not in shape or cfg.moe.n_experts % shape["model"] != 0:
        return apply_moe(p, cfg, x)
    # decode (one token per slot): weight-stationary path -- needs no
    # batch divisibility because the token set is replicated
    if (tuning.moe_decode_weight_stationary and x.shape[1] == 1
            and "data" in shape and cfg.d_model % shape["data"] == 0):
        return apply_moe_decode(p, cfg, x)
    if x.shape[0] % _dp_size(mesh) != 0:
        return apply_moe(p, cfg, x)
    if tuning.moe_all_to_all and x.shape[1] % shape["model"] == 0:
        return apply_moe_a2a(p, cfg, x)
    return apply_moe_sharded(p, cfg, x)


def _dp_size(mesh) -> int:
    shape = mesh_dict(mesh)
    n = shape.get("data", 1)
    if "pod" in shape:
        n *= shape["pod"]
    return n


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
