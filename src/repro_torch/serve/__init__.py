"""Serving: the paged KV pool -- host-side block allocator and the
device-side pool, scatter and gather.  The scheduler and decode engine of
the reference's `serve/` wait for the model layers (ROADMAP A11)."""
from .kv_blocks import (BlockAllocator, PoolConfig, gather_kv, init_pool,
                        pool_from_numpy, write_token)

__all__ = ["BlockAllocator", "PoolConfig", "gather_kv", "init_pool",
           "pool_from_numpy", "write_token"]
