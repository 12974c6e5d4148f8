"""Blocked-ELL (BELL) SpMV, plus-times: the CUDA kernel's wrapper, its
plain version, and the container oracle.

Kernel: `csrc/spmv_bell.cu`, which replaces the TPU kernel
`repro/kernels/spmv_bell.py:spmv_bell_pallas`.  Layout (see
`_layout.prepare_bell`): the real (bm, 128) blocks in container order,
`block_ptr[b] .. block_ptr[b+1]` those of block row b, `pad0[b]` set
where the container padded row b (a zero block at block column 0):

    y[b*bm + m] = Σ_k Σ_n blocks[p_k, m, n] * x[block_cols[p_k]*128 + n]
                  (+ Σ_n 0 * x[n] over the first tile where pad0[b])

Both versions reduce a block row's 128 products the kernel's way --
each of 32 lanes folds 4 neighbouring products in order, then an
xor-butterfly over the lanes -- and add the blocks in order from 0, so
they agree bit for bit on any input.
"""
from __future__ import annotations

import torch

from . import _build

BN = 128            # block width the kernel takes (one float4 per lane)


def _tree(prods: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis (128) in the kernel's order."""
    lanes = prods.reshape(prods.shape[:-1] + (32, 4))
    s = torch.zeros(lanes.shape[:-1], dtype=prods.dtype, device=prods.device)
    for j in range(4):
        s = s + lanes[..., j]
    for h in (16, 8, 4, 2, 1):
        s = s[..., :h] + s[..., h:2 * h]
    return s[..., 0]


def _tiles(x: torch.Tensor, n_tiles: int, width: int = BN) -> torch.Tensor:
    """x (or a batch of x) cut into `n_tiles` tiles of `width`, zero past
    its end."""
    pad = n_tiles * width - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)).reshape(
        x.shape[:-1] + (n_tiles, width))


def spmv_bell_plain(blocks: torch.Tensor, block_cols: torch.Tensor,
                    block_ptr: torch.Tensor, pad0: torch.Tensor,
                    x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Plain PyTorch version on the prepared layout."""
    n_brows, bm = block_ptr.shape[0] - 1, blocks.shape[1]
    tiles = _tiles(x, max(-(-x.shape[0] // BN), 1))
    sums = _tree(blocks * tiles[block_cols.long()][:, None, :])  # (nb, bm)
    ptr = block_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    acc = torch.zeros((n_brows, bm), dtype=x.dtype, device=x.device)
    for k in range(int(counts.max()) if n_brows else 0):
        rows = torch.nonzero(counts > k).flatten()
        acc[rows] = acc[rows] + sums[ptr[rows] + k]
    pad = _tree(torch.zeros_like(tiles[0]) * tiles[0])
    flagged = pad0.bool()
    acc[flagged] = acc[flagged] + pad
    return acc.reshape(-1)[:n_rows]


def spmv_bell(blocks: torch.Tensor, block_cols: torch.Tensor,
              block_ptr: torch.Tensor, pad0: torch.Tensor, x: torch.Tensor,
              n_rows: int) -> torch.Tensor:
    """y = A @ x for the prepared BELL layout: blocks (nb, bm, 128) f32,
    block_cols (nb,) int32, block_ptr (n_brows + 1,) int32, pad0
    (n_brows,) uint8, x (n_cols,) f32.  CUDA tensors launch the kernel,
    CPU tensors run the plain version."""
    if not _build.on_cuda(blocks, block_cols, block_ptr, pad0, x):
        return spmv_bell_plain(blocks, block_cols, block_ptr, pad0, x,
                               n_rows)
    _build.require(blocks, torch.float32, "blocks", 3)
    _build.require(block_cols, torch.int32, "block_cols", 1)
    _build.require(block_ptr, torch.int32, "block_ptr", 1)
    _build.require(pad0, torch.uint8, "pad0", 1)
    _build.require(x, torch.float32, "x", 1)
    n_brows, bm = block_ptr.shape[0] - 1, blocks.shape[1]
    if blocks.shape[2] != BN or not 0 < bm <= 32 \
            or block_cols.shape[0] != blocks.shape[0] \
            or pad0.shape[0] != n_brows or n_brows * bm < n_rows \
            or blocks.data_ptr() % 16:
        raise ValueError("spmv_bell: the kernel takes 16-byte aligned "
                         "(nb, bm <= 32, 128) blocks matching block_ptr")
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return y
    fn = _build.function("spmv_bell", "spmv_bell_f32",
                         [_build.PTR] * 6 + [_build.INT] * 4 + [_build.PTR])
    with torch.cuda.device(x.device):
        rc = fn(blocks.data_ptr(), block_cols.data_ptr(),
                block_ptr.data_ptr(), pad0.data_ptr(), x.data_ptr(),
                y.data_ptr(), n_rows, x.shape[0], n_brows, bm,
                _build.stream_of(x))
    _build.check(rc, "spmv_bell", "spmv_bell launch")
    spmv_bell.launches += 1
    return y


spmv_bell.launches = 0


def spmv_bell_torch(bell, x: torch.Tensor) -> torch.Tensor:
    """Container oracle (the reference's `spmv_bell_jnp`): gather each
    block's x tile, contract, cut to n_rows; `x` may be a (k, n)
    batch."""
    tiles = _tiles(x, max(-(-bell.n_cols // bell.bn), 1), bell.bn)
    gathered = tiles[..., bell.block_cols.long(), :]   # (.., nbr, bpr, bn)
    y = torch.einsum("rkmn,...rkn->...rm", bell.data, gathered)
    return y.reshape(x.shape[:-1] + (-1,))[..., :bell.n_rows]
