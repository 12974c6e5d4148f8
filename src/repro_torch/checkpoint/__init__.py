"""The reference's checkpoint layout for string-keyed dict trees of
numpy arrays (counterpart of the part of `repro.checkpoint` that the
shipped cost model needs), with its own MessagePack codec.

  manager        CheckpointManager: committed-step save and schema-free
                 `restore_any`; writes zlib shards, reads zlib and,
                 where `zstandard` imports, zstd
  msgpack_codec  packb / unpackb for the manifests and record leaves
"""
from .manager import CODEC, CheckpointManager, shard_filename
from .msgpack_codec import packb, unpackb

__all__ = ["CheckpointManager", "CODEC", "shard_filename", "packb",
           "unpackb"]
