"""Flash attention with causal and sliding-window masks: the CUDA
kernel's wrapper and its plain version.

Kernel: `csrc/flash_attention.cu`, which replaces the TPU kernel
`repro/kernels/flash_attention.py:flash_attention_pallas`.  Both compute,
per (batch·head), softmax(q kᵀ / √d) v on the reference's block grid
(bq, bk) = (min(bq, sq), min(bk, skv)): a kv block out of the (causal,
window) band is skipped for the whole q block, masked pairs inside a
relevant block carry the -1e30 sentinel, and the online softmax runs in
float32 (the kernel) or float64 (the plain version).  So a row whose
relevant blocks hold no visible key comes out as the mean of v over those
blocks (exp(-1e30 - -1e30) = 1), and a row with no relevant block at all
comes out 0 -- the kernel's behaviour, which the oracle `ref.mha_ref`
(zero for every fully masked row) does not share.
"""
from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30                    # the reference kernel's sentinel
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (64, 128)


def _block_grid(sq: int, skv: int, bq: int, bk: int):
    """The reference's (bq, bk) after `min` with the lengths; refuses
    what its `assert sq % bq == 0 and skv % bk == 0` refuses."""
    bq, bk = min(bq, sq), min(bk, skv)
    if bq < 1 or bk < 1 or sq % bq or skv % bk:
        raise ValueError(f"flash_attention: sq={sq} and skv={skv} must be "
                         f"multiples of the blocks bq={bq}, bk={bk}")
    return bq, bk


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError("flash_attention: q (bh, sq, d), k and v "
                         f"(bh, skv, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("flash_attention: q, k and v must share one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, window: int | None = None,
                          bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain PyTorch version: the reference kernel's block walk, one kv
    block at a time for every relevant q block at once, in float64 and
    rounded once to q's dtype.  (Float32 products summed in order, as a
    float32 matmul does, leave a peaked softmax's output about rtol 1e-4
    from the function's value; float64 keeps the oracle well inside the
    kernels' float32 check.)"""
    _check(q, k, v)
    bh, sq, d = q.shape
    skv = k.shape[1]
    bq, bk = _block_grid(sq, skv, bq, bk)
    scale = 1.0 / (d ** 0.5)
    qf, kf, vf = q.double(), k.double(), v.double()
    f64 = dict(dtype=torch.float64, device=q.device)
    m = torch.full((bh, sq, 1), NEG_INF, **f64)
    l = torch.zeros((bh, sq, 1), **f64)
    acc = torch.zeros((bh, sq, d), **f64)
    q_lo = torch.arange(0, sq, bq, device=q.device)
    for k_lo in range(0, skv, bk):
        rel = torch.ones_like(q_lo, dtype=torch.bool)
        if causal:
            rel &= k_lo <= q_lo + bq - 1
        if window is not None:
            rel &= k_lo + bk - 1 >= q_lo - window + 1
        blocks = torch.nonzero(rel).flatten().tolist()
        if not blocks:
            continue
        # the relevant q blocks are a run: causal keeps a suffix, the
        # window a prefix
        rows = slice(blocks[0] * bq, (blocks[-1] + 1) * bq)
        s = torch.matmul(qf[:, rows], kf[:, k_lo:k_lo + bk].transpose(1, 2))
        s = s * scale
        q_idx = torch.arange(rows.start, rows.stop, device=q.device)[:, None]
        k_idx = torch.arange(k_lo, k_lo + bk, device=q.device)[None, :]
        mask = torch.ones_like(s[0], dtype=torch.bool)
        if causal:
            mask &= q_idx >= k_idx
        if window is not None:
            mask &= q_idx - k_idx < window
        s = torch.where(mask, s, NEG_INF)
        m_prev = m[:, rows]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m_prev - m_new)
        l[:, rows] = l[:, rows] * corr + p.sum(dim=-1, keepdim=True)
        acc[:, rows] = acc[:, rows] * corr + torch.matmul(
            p, vf[:, k_lo:k_lo + bk])
        m[:, rows] = m_new
    out = torch.where(l == 0.0, 0.0, acc / torch.where(l == 0.0, 1.0, l))
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q: (bh, sq, d), k/v: (bh, skv, d) -> (bh, sq, d) in q's dtype.

    `window`: sliding-window size (None = full attention); float32
    accumulation.  CUDA tensors launch the kernel (float32 or bfloat16,
    d in (64, 128), contiguous and 16-byte aligned, else ValueError):
    bfloat16 runs one CUDA kernel, float32 three (K and V split into tf32
    hi and lo, then the 3xTF32 kernel, in a workspace of 4 bh·skv·d
    floats).  CPU tensors run the plain version.  Neither has a
    backward: with grad mode on, an input that requires grad raises
    RuntimeError (`_build.refuse_autograd`)."""
    _check(q, k, v)
    _build.refuse_autograd("flash_attention", q, k, v)
    bh, sq, d = q.shape
    skv = k.shape[1]
    fq, fk = _block_grid(sq, skv, bq, bk)
    if not _build.on_cuda(q, k, v):
        return flash_attention_plain(q, k, v, causal, window, bq, bk)
    if q.dtype not in KERNEL_DTYPES or d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes float32 or "
                         f"bfloat16 with d in {KERNEL_HEAD_DIMS}, got "
                         f"{q.dtype}, d={d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, q.dtype, name, 3)
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             "aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # a window beyond the sequences masks nothing more (or everything):
    # clamping keeps it in a C int without changing a single pair
    w = 0 if window is None else max(min(int(window), sq + 1), -(skv + 1))
    # float32 runs on the tensor cores from K and Vᵀ split into tf32 hi and
    # lo: K hi, K lo (bh, skv, d) and Vᵀ hi, Vᵀ lo (bh, d, skv rounded up
    # to 8), written by the launch's split passes
    n_ws = 2 * bh * d * (skv + -(-skv // 8) * 8) \
        if q.dtype == torch.float32 else 0
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    fn = _build.function(
        "flash_attention", "flash_attention_fwd",
        [_build.PTR] * 4 + [_build.INT] * 9 + [_build.FLOAT, _build.INT,
                                               _build.PTR, _build.INT64,
                                               _build.PTR])
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                bh, sq, skv, d, fq, fk, int(causal), int(window is not None),
                w, 1.0 / (d ** 0.5), KERNEL_DTYPES[q.dtype],
                ws.data_ptr() if n_ws else None, n_ws, _build.stream_of(q))
    _build.check(rc, "flash_attention", "flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
