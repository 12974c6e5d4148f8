"""Serving: paged KV blocks, continuous-batching scheduler, decode
engine -- the host-side block allocator, the device-side pool with its
scatter and gather, the reference's scheduler, and the engine that
serves a decoder LM through the flash and paged attention kernels."""
from .engine import Engine, EngineConfig, make_engine
from .kv_blocks import (BlockAllocator, PoolConfig, gather_kv, init_pool,
                        pool_from_numpy, write_token)
from .scheduler import Request, Scheduler, Slot

__all__ = ["Engine", "EngineConfig", "make_engine", "BlockAllocator",
           "PoolConfig", "gather_kv", "init_pool", "pool_from_numpy",
           "write_token", "Request", "Scheduler", "Slot"]
