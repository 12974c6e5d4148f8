"""Paged decode attention over a block-table KV pool, with grouped-query
attention: the CUDA kernel's wrapper and its plain version.

Kernel: `csrc/paged_attention.cu`, which replaces the TPU kernel
`repro/kernels/paged_attention.py:paged_attention_pallas` together with
the GQA repeat of `repro/kernels/ops.py:paged_attention`.  Layout (the
reference's, at the public function):

    q        (B, H, hd)
    k_pool   (n_blocks, block, KVH, hd), KVH divides H; query head h
    v_pool   reads KV head h // (H // KVH) -- `jnp.repeat`'s order
    tables   (B, max_blocks) int32: physical block of each logical block
    lengths  (B,) int32: tokens in each sequence
    out      (B, H, hd), q's dtype

Both versions walk each sequence's logical blocks j < ceil(length /
block) (at most max_blocks), mask positions at or past the length with
the -1e30 sentinel, run the online softmax in float32 and give 0 where
no block was walked (length 0).  Table entries past that bound are never
dereferenced, whatever they hold.  An entry inside it that is not a
block of the pool makes that sequence's output NaN.
"""
from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30                    # the reference kernel's sentinel
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_MAX_GROUP = 16              # query heads per KV head
CHUNK = 32                         # tokens a kernel chunk holds (csrc CH)
SPAN_TARGET = 512                  # tokens a CTA of the kernel walks, about


def split_plan(block: int, max_blocks: int) -> tuple[int, int]:
    """(span, n_split) of the kernel's split walk, from the shapes alone:
    a sequence's positions [0, max_blocks·block) are cut into n_split
    spans of `span` tokens, the largest multiple of lcm(block, CHUNK) up
    to SPAN_TARGET (at least one such multiple)."""
    unit = block * CHUNK // math.gcd(block, CHUNK)
    span = unit * max(1, SPAN_TARGET // unit)
    return span, -(-max_blocks * block // span)


def _check(q, k_pool, v_pool, tables, lengths):
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != q.shape[2] or tables.dim() != 2 \
            or lengths.shape != (q.shape[0],) \
            or tables.shape[0] != q.shape[0]:
        raise ValueError(
            "paged_attention: q (B, H, hd), pools (n_blocks, block, KVH, "
            "hd), tables (B, max_blocks), lengths (B,); got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
            f"{tuple(v_pool.shape)}, {tuple(tables.shape)}, "
            f"{tuple(lengths.shape)}")
    kvh = k_pool.shape[2]
    if kvh < 1 or q.shape[1] % kvh:
        raise ValueError(f"paged_attention: {kvh} KV heads do not divide "
                         f"{q.shape[1]} query heads")
    if not q.dtype == k_pool.dtype == v_pool.dtype:
        raise ValueError("paged_attention: q and the pools must share one "
                         f"dtype, got {q.dtype}, {k_pool.dtype}, "
                         f"{v_pool.dtype}")


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one logical block of every sequence at a
    time, each KV head serving its group of query heads."""
    _check(q, k_pool, v_pool, tables, lengths)
    bsz, h, hd = q.shape
    n_blocks, block, kvh, _ = k_pool.shape
    g = h // kvh
    scale = 1.0 / (hd ** 0.5)
    qf = q.float().reshape(bsz, kvh, g, hd)
    lens = lengths.long()
    tbl = tables.long()
    nb = torch.clamp(-(-lens // block), 0, tables.shape[1])  # blocks walked
    m = torch.full((bsz, kvh, g, 1), NEG_INF, device=q.device)
    l = torch.zeros((bsz, kvh, g, 1), device=q.device)
    acc = torch.zeros((bsz, kvh, g, hd), device=q.device)
    bad = torch.zeros(bsz, dtype=torch.bool, device=q.device)
    offs = torch.arange(block, device=q.device)
    for j in range(int(nb.max()) if bsz else 0):
        walk = j < nb
        ids = tbl[:, j]
        outside = walk & ((ids < 0) | (ids >= n_blocks))
        bad |= outside
        ids = torch.where(walk & ~outside, ids, 0)   # read no other entry
        kb = k_pool[ids].float()                      # (B, block, KVH, hd)
        vb = v_pool[ids].float()
        s = torch.einsum("bkgd,btkd->bkgt", qf, kb) * scale
        pos = j * block + offs
        s = torch.where(pos < lens[:, None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        sel = walk[:, None, None, None]
        l = torch.where(sel, l * corr + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(
            sel, acc * corr + torch.einsum("bkgt,btkd->bkgd", p, vb), acc)
        m = torch.where(sel, m_new, m)
    out = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    out = torch.where(bad[:, None, None, None], float("nan"), out)
    return out.reshape(bsz, h, hd).to(q.dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Decode attention of q (B, H, hd) over the pools (n_blocks, block,
    KVH, hd) through tables (B, max_blocks) and lengths (B,) -> (B, H,
    hd).  CUDA tensors launch the kernel (float32 or bfloat16, hd in
    (32, 64, 128), H // KVH <= 16, int32 tables and lengths, contiguous
    and 16-byte aligned, else ValueError): two CUDA kernels a call, the
    split walk over `split_plan`'s spans, which writes each span's
    partial softmax to a workspace of B·H·n_split·(hd + 2) + B·KVH·n_split
    4-byte words, and the merge of the spans in split order.  CPU tensors
    run the plain version.  Neither has a backward: with grad mode on, an
    input that requires grad raises RuntimeError
    (`_build.refuse_autograd`)."""
    _check(q, k_pool, v_pool, tables, lengths)
    _build.refuse_autograd("paged_attention", q, k_pool, v_pool)
    if not _build.on_cuda(q, k_pool, v_pool, tables, lengths):
        return paged_attention_plain(q, k_pool, v_pool, tables, lengths)
    bsz, h, hd = q.shape
    n_blocks, block, kvh, _ = k_pool.shape
    if q.dtype not in KERNEL_DTYPES or hd not in KERNEL_HEAD_DIMS \
            or h // kvh > KERNEL_MAX_GROUP:
        raise ValueError(
            f"paged_attention: the kernel takes float32 or bfloat16 with hd "
            f"in {KERNEL_HEAD_DIMS} and at most {KERNEL_MAX_GROUP} query "
            f"heads per KV head, got {q.dtype}, hd={hd}, H={h}, KVH={kvh}")
    _build.require(q, q.dtype, "q", 3)
    _build.require(k_pool, q.dtype, "k_pool", 4)
    _build.require(v_pool, q.dtype, "v_pool", 4)
    _build.require(tables, torch.int32, "tables", 2)
    _build.require(lengths, torch.int32, "lengths", 1)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention: {name} is not 16-byte "
                             "aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    max_blocks = tables.shape[1]
    span, n_split = split_plan(block, max_blocks)
    ws = torch.empty(bsz * n_split * (h * (hd + 2) + kvh),
                     dtype=torch.float32, device=q.device)
    fn = _build.function(
        "paged_attention", "paged_attention_fwd",
        [_build.PTR] * 6 + [_build.INT] * 9 + [_build.FLOAT, _build.INT,
                                               _build.PTR, _build.PTR])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                bsz, h, kvh, hd, n_blocks, block, max_blocks, span, n_split,
                1.0 / (hd ** 0.5), KERNEL_DTYPES[q.dtype],
                ws.data_ptr() if ws.numel() else None, _build.stream_of(q))
    _build.check(rc, "paged_attention", "paged_attention launch")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
