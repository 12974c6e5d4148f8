"""The reference's checkpoint layout for trees of numpy arrays and
tensors (counterpart of `repro.checkpoint`), with its own MessagePack
codec.

  manager        CheckpointManager: committed-step save (blocking or in
                 the background), `restore(step, target)` by key and the
                 schema-free `restore_any` of dict trees; writes zlib
                 shards, reads zlib and, where `zstandard` imports, zstd
  msgpack_codec  packb / unpackb for the manifests and record leaves
"""
from .manager import CODEC, CheckpointManager, shard_filename
from .msgpack_codec import packb, unpackb

__all__ = ["CheckpointManager", "CODEC", "shard_filename", "packb",
           "unpackb"]
