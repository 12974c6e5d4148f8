"""Collective helpers: the counterpart of `repro.distributed.collectives`,
for `shard_map` bodies (`distributed.api`).

  * ring_allgather_matmul -- y = x @ all_gather(w) with the weight shards
    passed round the ring by `ppermute`, one partial product a step;
  * lse_merge_attention   -- merges per-shard attention partials computed
    over a sequence-sharded KV cache with a pmax and two psums instead
    of all-gathering KV;
  * reduce_scatter_grads  -- ZeRO-2: each member keeps 1/n of the summed
    gradient;
  * crosspod_allreduce_compressed -- re-export of the int8 error-feedback
    all-reduce from optim.grad_compress.
"""
from __future__ import annotations

import torch

from repro_torch.optim.grad_compress import (  # noqa: F401
    crosspod_allreduce_compressed)
from repro_torch.tree import tree_map
from .api import axis_index, axis_size, pmax, ppermute, psum, psum_scatter


def ring_allgather_matmul(x: torch.Tensor, w_shard: torch.Tensor,
                          axis_name: str) -> torch.Tensor:
    """Inside shard_map: y = x @ all_gather(w, axis) without a blocking
    all-gather.  w_shard: (d_in/n, d_out) local shard; x: (..., d_in).

    Each of the n steps multiplies the currently-held shard and passes
    the shards one member down the ring.
    """
    n = axis_size(axis_name)
    idx = axis_index(axis_name)
    chunk = x.shape[-1] // n
    acc = torch.zeros(x.shape[:-1] + (w_shard.shape[-1],),
                      dtype=torch.promote_types(x.dtype, w_shard.dtype),
                      device=x.device)
    w_cur = w_shard
    for i in range(n):
        src = (idx + i) % n
        x_chunk = x.narrow(-1, src * chunk, chunk)
        acc = acc + x_chunk @ w_cur
        w_cur = ppermute(w_cur, axis_name,
                         perm=[(j, (j - 1) % n) for j in range(n)])
    return acc


def lse_merge_attention(q: torch.Tensor, k_shard: torch.Tensor,
                        v_shard: torch.Tensor, axis_name: str,
                        positions_valid: torch.Tensor) -> torch.Tensor:
    """Decode attention over sequence-sharded KV without gathering KV.

    q: (B, H, 1, hd); k/v_shard: (B, S/n, KVH, hd) local slice;
    positions_valid: (B, S/n) bool mask for the local slice.
    Each shard computes its partial softmax numerator/denominator; the
    merge is a psum of (exp-shifted) partials -- O(B*H*hd) bytes on the
    wire instead of O(B*S*KVH*hd).
    """
    b, h, _, hd = q.shape
    kvh = k_shard.shape[2]
    g = h // kvh
    qf = q.reshape(b, kvh, g, hd).float()
    kf = k_shard.float()
    vf = v_shard.float()
    s = torch.einsum("bkgd,bskd->bkgs", qf, kf) / (hd ** 0.5)
    s = torch.where(positions_valid[:, None, None, :], s,
                    s.new_full((), -1e30))
    m_local = s.amax(dim=-1, keepdim=True)
    m_global = pmax(m_local, axis_name)
    p = torch.exp(s - m_global)
    num = torch.einsum("bkgs,bskd->bkgd", p, vf)
    den = p.sum(dim=-1, keepdim=True)
    num = psum(num, axis_name)
    den = psum(den, axis_name)
    out = num / den.clamp(min=1e-30)
    return out.reshape(b, h, 1, hd)


def reduce_scatter_grads(grads, axis_name: str):
    """ZeRO-2: each worker keeps 1/n of the (summed) gradient."""
    n = axis_size(axis_name)

    def one(g):
        if g.dim() and g.shape[0] % n == 0:
            return psum_scatter(g, axis_name)
        return psum(g, axis_name)

    return tree_map(one, grads)
