"""Oracles of the attention kernels: the counterparts of the reference's
`repro/kernels/ref.py` `mha_ref` and `paged_attention_ref`.

They compute the reference ORACLES' function, which is not the kernels'
where a mask leaves a row empty: `mha_ref` gives 0 for every row without
a visible key (the kernel gives the mean of v over a relevant block), and
`paged_attention_ref` gives a uniform softmax over the whole padded table
at length 0 (the kernel gives 0).  Used by tests only.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); pools: (n_blocks, block, H, hd); tables: (B,
    max_blocks); lengths: (B,) -> (B, H, hd)."""
    bsz, h, hd = q.shape
    block = k_pool.shape[1]
    max_blocks = tables.shape[1]
    kb = k_pool[tables.long()]                 # (B, mb, blk, H, hd)
    vb = v_pool[tables.long()]
    kf = kb.reshape(bsz, max_blocks * block, h, hd).float()
    vf = vb.reshape(bsz, max_blocks * block, h, hd).float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), kf)
    s = s / (hd ** 0.5)
    pos = torch.arange(max_blocks * block, device=q.device)[None, None, :]
    s = torch.where(pos < lengths.long()[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vf).to(q.dtype)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Masked softmax attention oracle. q: (bh, sq, d), k/v: (bh, skv,
    d)."""
    sq, skv = q.shape[1], k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    q_idx = torch.arange(sq, device=q.device)[:, None]
    k_idx = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_idx >= k_idx
    if window is not None:
        mask &= (q_idx - k_idx) < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows that are fully masked give a uniform softmax over -1e30; zero them
    any_valid = mask.any(dim=1)[None, :, None]
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return torch.where(any_valid, out, 0.0).to(q.dtype)
