"""Blocked-ELL (BELL) SpMV, plus-times: the CUDA kernel's wrapper, its
plain version, and the container oracle.

Kernel: `csrc/spmv_bell.cu`, which replaces the TPU kernel
`repro/kernels/spmv_bell.py:spmv_bell_pallas`.  Layout (see
`_layout.prepare_bell`): the real (bm, 128) blocks in container order,
`block_ptr[b] .. block_ptr[b+1]` those of block row b, each stored as
its kept columns only -- `masks[p]` (128 bits as 4 int32 words) marks
the columns where some row of block p is nonzero, and its k kept
columns' values lie at `values[val_ptr[p]:]`, column by column, bm per
column -- and `pad0[b]` set where the container padded block row b:

    y[b*bm + m] = Σ_p Σ_{n kept} block_p[m, n] * x[bc_p*128 + n]
                  (+ 0 * x[bc_p*128 + n] over its dropped columns n)
                  (+ Σ_n 0 * x[n] over the first tile where pad0[b])

The zero terms add +0, or NaN when that x is not finite: a block whose
x tile holds a non-finite value ("flagged") checks its dropped columns,
and a padded block row checks the flag of tile 0.  Both versions fold a
block row's products the kernel's way -- `lanes` lanes per row, lane
(g, m) taking row m and kept columns g, g + lanes, ... in order, then an
xor-butterfly joining the lanes of each row -- and add the blocks in
order from 0, so they agree bit for bit on any input.
"""
from __future__ import annotations

import torch

from . import _build

BN = 128            # block width: a 128-bit column mask per block


def _tiles(x: torch.Tensor, n_tiles: int, width: int = BN) -> torch.Tensor:
    """x (or a batch of x) cut into `n_tiles` tiles of `width`, zero past
    its end."""
    pad = n_tiles * width - x.shape[-1]
    return torch.nn.functional.pad(x, (0, pad)).reshape(
        x.shape[:-1] + (n_tiles, width))


def column_mask(masks: torch.Tensor) -> torch.Tensor:
    """(nb, 4) int32 words -> (nb, 128) bool: bit n % 32 of word n // 32
    is column n."""
    bits = torch.arange(32, dtype=torch.int32, device=masks.device)
    return ((masks[:, :, None] >> bits) & 1).bool().reshape(-1, BN)


def spmv_bell_plain(prep, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on the prepared layout."""
    bm = prep.bm
    groups = prep.lanes                # lanes per row
    n_brows = prep.block_ptr.shape[0] - 1
    tiles = _tiles(x, max(-(-x.shape[0] // BN), 1))
    flags = ~torch.isfinite(tiles).all(dim=1)              # (n_tiles,)
    kept = column_mask(prep.masks)                          # (nb, 128)
    nb = kept.shape[0]
    k = kept.sum(dim=1)
    width = -(-int(k.max()) // groups) * groups if nb else 0
    # kept columns first, ascending: slot j of block p is its j-th one
    col = torch.sort((~kept).to(torch.uint8), dim=1, stable=True).indices[
        :, :width]
    real = torch.arange(width, device=x.device) < k[:, None]   # (nb, w)
    xt = tiles[prep.block_cols.long()]                      # (nb, 128)
    xs = torch.where(real, torch.gather(xt, 1, col), 0.0)
    # a padding slot reads the one +0 appended past the values
    padded = torch.cat([prep.values, prep.values.new_zeros(1)])
    idx = prep.val_ptr[:, None, None] + bm * torch.arange(
        width, device=x.device)[:, None] + torch.arange(bm, device=x.device)
    vals = padded[torch.where(real[:, :, None], idx,
                              prep.values.numel())]         # (nb, w, bm)
    prods = (vals * xs[:, :, None]).reshape(nb, width // groups, groups, bm)
    s = torch.zeros((nb, groups, bm), dtype=x.dtype, device=x.device)
    for t in range(width // groups):   # each lane's columns, in order
        s = s + prods[:, t]
    h = groups
    while h > 1:                        # the xor-butterfly, lane 0's view
        h //= 2
        s = s[:, :h] + s[:, h:2 * h]
    sums = s[:, 0]                                          # (nb, bm)
    dropped_bad = (~kept & ~torch.isfinite(xt)).any(dim=1)
    sums = torch.where(dropped_bad[:, None], sums + float("nan"), sums)
    ptr = prep.block_ptr.long()
    counts = ptr[1:] - ptr[:-1]
    acc = torch.zeros((n_brows, bm), dtype=x.dtype, device=x.device)
    for j in range(int(counts.max()) if n_brows else 0):
        rows = torch.nonzero(counts > j).flatten()
        acc[rows] = acc[rows] + sums[ptr[rows] + j]
    if bool(flags[0]):
        acc[prep.pad0.bool()] += float("nan")
    return acc.reshape(-1)[:prep.n_rows]


def spmv_bell(prep, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for the prepared BELL layout (values f32, val_ptr
    int64, masks (nb, 4) int32, block_cols int32, block_ptr int32, pad0
    uint8; bm * lanes divides 32).  CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    tensors = {"values": (torch.float32, 1), "val_ptr": (torch.int64, 1),
               "masks": (torch.int32, 2), "block_cols": (torch.int32, 1),
               "block_ptr": (torch.int32, 1), "pad0": (torch.uint8, 1)}
    if not _build.on_cuda(x, *(getattr(prep, n) for n in tensors)):
        return spmv_bell_plain(prep, x)
    for name, (dtype, ndim) in tensors.items():
        _build.require(getattr(prep, name), dtype, name, ndim)
    _build.require(x, torch.float32, "x", 1)
    n_brows, nb, bm = prep.block_ptr.shape[0] - 1, prep.masks.shape[0], \
        prep.bm
    size = bm * prep.lanes
    if not (0 < size <= 32 and 32 % size == 0) \
            or prep.lanes & (prep.lanes - 1) or prep.masks.shape[1] != 4 \
            or prep.masks.data_ptr() % 16 \
            or prep.block_cols.shape[0] != nb or prep.val_ptr.shape[0] != nb \
            or prep.pad0.shape[0] != n_brows or n_brows * bm < prep.n_rows \
            or x.shape[0] != prep.n_cols:
        raise ValueError("spmv_bell: the kernel takes bm * lanes | 32 and "
                         "16-byte aligned (nb, 4) masks matching block_ptr")
    y = torch.empty(prep.n_rows, dtype=torch.float32, device=x.device)
    if prep.n_rows == 0:
        return y
    flags = torch.empty(max(-(-x.shape[0] // BN), 1) + 1, dtype=torch.uint8,
                        device=x.device)
    fn = _build.function("spmv_bell", "spmv_bell_f32",
                         [_build.PTR] * 9 + [_build.INT] * 5 + [_build.PTR])
    with torch.cuda.device(x.device):
        rc = fn(prep.values.data_ptr(), prep.val_ptr.data_ptr(),
                prep.masks.data_ptr(), prep.block_cols.data_ptr(),
                prep.block_ptr.data_ptr(), prep.pad0.data_ptr(),
                x.data_ptr(), flags.data_ptr(), y.data_ptr(), prep.n_rows,
                x.shape[0], n_brows, bm, prep.lanes, _build.stream_of(x))
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
    return y.reshape(x.shape[:-1] + (bell.data.shape[0] * bell.bm,))[
        ..., :bell.n_rows]
