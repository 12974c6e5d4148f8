"""Paged KV-cache pool: the counterpart of the reference's
`repro/serve/kv_blocks.py`.

The pool is carved into fixed-size blocks; a sequence's cache is a list
of block ids (its block table), which `kernels.paged_attention` reads
through.  `PoolConfig` and `BlockAllocator` are host-side numpy and make
the reference's decisions exactly: the same free list (lowest id popped
first), tables, 0-padded `table_array`, `utilization`, and the same
`MemoryError` / `False` points.  `init_pool`, `write_token` and
`gather_kv` work on tensors on an explicit device (None = the card).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.device import resolve_device, to_tensor


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    n_blocks: int            # total physical blocks in the pool
    block_size: int          # tokens per block
    max_blocks_per_seq: int  # static bound: ceil(max_context / block_size)


class BlockAllocator:
    """Free-list allocator over the physical pool.  O(1) alloc/free."""

    def __init__(self, cfg: PoolConfig):
        self.cfg = cfg
        self.free: List[int] = list(range(cfg.n_blocks - 1, -1, -1))
        self.tables: Dict[int, List[int]] = {}      # seq_id -> block ids
        self.lengths: Dict[int, int] = {}           # seq_id -> tokens used

    @property
    def n_free(self) -> int:
        return len(self.free)

    def blocks_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.cfg.block_size)

    def can_admit(self, n_tokens: int) -> bool:
        return self.blocks_needed(n_tokens) <= self.n_free

    def admit(self, seq_id: int, n_tokens: int) -> List[int]:
        need = self.blocks_needed(max(n_tokens, 1))
        if need > self.n_free or need > self.cfg.max_blocks_per_seq:
            raise MemoryError(
                f"seq {seq_id}: need {need} blocks, free {self.n_free}")
        blocks = [self.free.pop() for _ in range(need)]
        self.tables[seq_id] = blocks
        self.lengths[seq_id] = n_tokens
        return blocks

    def extend(self, seq_id: int, n_new_tokens: int = 1) -> bool:
        """Grow a sequence; returns False when the pool is exhausted or
        the sequence is at `max_blocks_per_seq` (the caller preempts --
        scheduler policy, not allocator policy).  Blocks taken before
        that point stay in the table, as in the reference."""
        new_len = self.lengths[seq_id] + n_new_tokens
        need = self.blocks_needed(new_len)
        table = self.tables[seq_id]
        while len(table) < need:
            if not self.free or len(table) >= self.cfg.max_blocks_per_seq:
                return False
            table.append(self.free.pop())
        self.lengths[seq_id] = new_len
        return True

    def release(self, seq_id: int) -> None:
        for b in self.tables.pop(seq_id, []):
            self.free.append(b)
        self.lengths.pop(seq_id, None)

    def table_array(self, seq_id: int) -> np.ndarray:
        """Fixed-width block table (padded with 0) for device code."""
        t = self.tables.get(seq_id, [])
        out = np.zeros((self.cfg.max_blocks_per_seq,), np.int32)
        out[: len(t)] = t
        return out

    def utilization(self) -> float:
        return 1.0 - self.n_free / self.cfg.n_blocks


# ---------------------------------------------------------------------------
# device-side pool
# ---------------------------------------------------------------------------

def init_pool(cfg: PoolConfig, n_kv_heads: int, head_dim: int, n_layers: int,
              dtype=torch.bfloat16, device=None) -> dict:
    """Physical pool: (L, n_blocks, block, KVH, hd) zeros for k and v."""
    dev = resolve_device(device)
    shape = (n_layers, cfg.n_blocks, cfg.block_size, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def pool_from_numpy(pool: dict, device=None) -> dict:
    """The reference's `{"k", "v"}` pool (arrays of (L, n_blocks, block,
    KVH, hd)) as tensors on `device`, dtype and bytes unchanged; a
    bfloat16 array (numpy's `ml_dtypes` type) crosses as its raw 16-bit
    words."""
    dev = resolve_device(device)
    return {name: to_tensor(pool[name], dev) for name in ("k", "v")}


def write_token(pool: dict, layer: int, block_ids: torch.Tensor,
                offsets: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor) -> dict:
    """Scatter one token's KV for a batch of slots.

    block_ids/offsets: (B,) physical block + within-block offset per
    slot; k_new/v_new: (B, KVH, hd).  The pool is updated IN PLACE
    (`index_put_`) and returned; the reference is functional
    (`.at[].set`) and returns a new pool."""
    k, v = pool["k"], pool["v"]
    dev = k.device
    idx = (torch.as_tensor(layer, device=dev),
           torch.as_tensor(block_ids, device=dev).long(),
           torch.as_tensor(offsets, device=dev).long())
    k.index_put_(idx, k_new.to(device=dev, dtype=k.dtype))
    v.index_put_(idx, v_new.to(device=dev, dtype=v.dtype))
    return pool


def gather_kv(pool: dict, layer: int, tables: torch.Tensor):
    """Per-slot contiguous KV views assembled from the pool.

    tables: (B, max_blocks) physical block ids (0-padded).
    Returns k, v: (B, max_blocks * block, KVH, hd)."""
    t = torch.as_tensor(tables, device=pool["k"].device).long()
    kb = pool["k"][layer][t]                 # (B, mb, blk, KVH, hd)
    vb = pool["v"][layer][t]
    b, mb, blk, kvh, hd = kb.shape
    return (kb.reshape(b, mb * blk, kvh, hd),
            vb.reshape(b, mb * blk, kvh, hd))
