"""Read and write the reference's checkpoint layout: the counterpart of
`repro.checkpoint.manager`, without JAX or the `msgpack` package.

Trees are nested dicts (string keys), lists, tuples and NamedTuples of
numpy arrays or tensors (`repro_torch.tree`): the shipped cost model
(`plan.serial`), the sweep runner's records, and the trainer's
(params, optimizer state).  One directory per step:

    ckpt_dir/
      step_000000123/
        manifest.msgpack      # step, hosts, codec, tree description and
                              # one entry per leaf (key, shape, dtype,
                              # offset, nbytes, shard)
        shard_00000.bin.zlib  # the leaves' bytes, concatenated in key
                              # order, zlib level 3
        COMMITTED             # written last: a step without it is torn

Keys are `jax.tree_util.keystr` paths (`['a']['b']`, `[0]['embed']`,
`[1].mu['stacks'][0]...`) and the tree description is
`str(jax.tree.structure(tree))`'s text, so a tree written here has the
reference's manifest and shard bytes: bfloat16 leaves as their 16-bit
words under dtype "bfloat16", a tensor's bytes row-major whatever its
strides.  `restore(step, target)` fills a target's structure by key, as
the reference's does; `restore_any` rebuilds string-keyed dict trees
from the manifest alone.  Writes use zlib (the
shipped artifact's codec).  Reads take the codec the manifest names,
from the reference's registry: zlib always, zstd (`shard_NNNNN.bin.zst`,
the reference's default wherever the optional `zstandard` imports) when
`zstandard` imports here too; a codec that is not available raises the
reference's `ModuleNotFoundError`, naming it.
Saves are single-host.  `save` snapshots the leaves to host memory at
once; with `blocking=False` a background thread compresses and writes
them, as the reference's default does (`wait` joins it before the next
save or a read).  After each save only the newest `keep` committed steps
stay, as in the reference.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, map_with_path, structure
from .msgpack_codec import packb, unpackb

try:
    import zstandard as zstd
except ModuleNotFoundError:          # optional, as in the reference
    zstd = None

CODEC = "zlib"                       # what `save` writes
#: codec name -> decompress, for the codecs that can be read here
_DECOMPRESS = {"zlib": zlib.decompress}
if zstd is not None:
    _DECOMPRESS["zstd"] = lambda b: zstd.ZstdDecompressor().decompress(b)
#: shard-file extensions per codec name, whether or not it reads here
_EXTS = {"zstd": "zst", "zlib": "zlib"}
_DICT_KEY = re.compile(r"\['([^']*)'\]")


def shard_filename(shard_id: int, codec: str = CODEC) -> str:
    return f"shard_{shard_id:05d}.bin.{_EXTS.get(codec, codec)}"


def decompressor(codec: str):
    """The decompress function of `codec`; the reference's error for a
    codec that is not available here."""
    if codec not in _DECOMPRESS:
        raise ModuleNotFoundError(
            f"checkpoint was written with codec {codec!r}, which is not "
            f"available here (have: {sorted(_DECOMPRESS)})")
    return _DECOMPRESS[codec]


def _check_keys(tree) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not isinstance(k, str):
                raise TypeError(
                    f"checkpoint trees take string keys, got {k!r}")
            _check_keys(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _check_keys(v)


def _record(leaf) -> Tuple[bytes, List[int], str]:
    """(bytes, shape, dtype name) of a leaf, as the reference stores
    it: row-major, bfloat16 as its 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return (t.view(torch.int16).numpy().tobytes(), list(t.shape),
                    "bfloat16")
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return np.ascontiguousarray(a).tobytes(), list(a.shape), str(a.dtype)


def _to_tensor(buf: bytes, shape, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        words = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(buf, np.dtype(dtype))
                            .reshape(shape).copy())


class CheckpointManager:
    """Committed-step save and schema-free restore of dict trees; the
    newest `keep` committed steps survive each save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Any, blocking: bool = True) -> str:
        """Write `tree` as committed step `step`; returns the step dir.
        The leaves are copied to host memory before it returns; with
        `blocking=False` compression and IO run on a background thread,
        whose error the next `wait` (or save, or read) raises."""
        self.wait()
        _check_keys(tree)
        flat = {key: _record(leaf) for key, leaf in leaves_with_path(tree)}
        treedef = structure(tree)
        step_dir = os.path.join(self.dir, f"step_{step:09d}")
        if blocking:
            self._write(step, step_dir, flat, treedef)
            return step_dir

        def write():
            try:
                self._write(step, step_dir, flat, treedef)
            except Exception as e:      # raised again by wait()
                self._error = e
        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        return step_dir

    def _write(self, step: int, step_dir: str, flat: Dict, treedef: str):
        os.makedirs(step_dir, exist_ok=True)
        entries: List[Dict] = []
        payload = bytearray()
        for key in sorted(flat):
            buf, shape, dtype = flat[key]
            entries.append({"key": key, "shape": shape, "dtype": dtype,
                            "offset": len(payload), "nbytes": len(buf),
                            "shard": 0})
            payload.extend(buf)
        shard_path = os.path.join(step_dir, shard_filename(0))
        with open(shard_path + ".tmp", "wb") as f:
            f.write(zlib.compress(bytes(payload), 3))
        os.replace(shard_path + ".tmp", shard_path)
        manifest = {"step": step, "n_hosts": 1, "codec": CODEC,
                    "treedef": treedef, "entries": entries}
        mpath = os.path.join(step_dir, "manifest.msgpack")
        with open(mpath + ".tmp", "wb") as f:
            f.write(packb(manifest))
        os.replace(mpath + ".tmp", mpath)
        with open(os.path.join(step_dir, "COMMITTED"), "w") as f:
            f.write(str(step))
        for old in self.committed_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{old:09d}"))

    def wait(self) -> None:
        """Join a background save; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def committed_steps(self) -> List[int]:
        if not os.path.isdir(self.dir):
            return []
        return [int(name.split("_")[1]) for name in sorted(os.listdir(self.dir))
                if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "COMMITTED"))]

    def latest_step(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> Tuple[str, int]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        return os.path.join(self.dir, f"step_{step:09d}"), step

    def load_manifest(self, step: Optional[int] = None) -> Dict:
        """The manifest of a committed step (newest when None)."""
        step_dir, _ = self._step_dir(step)
        with open(os.path.join(step_dir, "manifest.msgpack"), "rb") as f:
            return unpackb(f.read())

    def _reader(self, step: Optional[int]):
        """(manifest, step, entry -> its bytes) of a committed step."""
        self.wait()
        step_dir, step = self._step_dir(step)
        manifest = self.load_manifest(step)
        codec = manifest.get("codec", "zstd")
        decompress = decompressor(codec)     # refused before any read
        shards: Dict[int, bytes] = {}

        def read(e: Dict) -> bytes:
            sid = e["shard"]
            if sid not in shards:
                path = os.path.join(step_dir, shard_filename(sid, codec))
                with open(path, "rb") as f:
                    shards[sid] = decompress(f.read())
            return shards[sid][e["offset"]:e["offset"] + e["nbytes"]]
        return manifest, step, read

    def restore_any(self, step: Optional[int] = None) -> Tuple[Dict, int]:
        """(tree, step) rebuilt from the manifest alone: nested dicts of
        numpy arrays with the saved dtypes and shapes."""
        manifest, step, read = self._reader(step)
        tree: Dict = {}
        for e in manifest["entries"]:
            key = e["key"]
            parts = _DICT_KEY.findall(key)
            if "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"restore_any supports string-keyed dict "
                                 f"trees only; cannot rebuild node {key!r}")
            leaf = np.frombuffer(read(e), np.dtype(e["dtype"])) \
                .reshape(e["shape"]).copy()
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
        return tree, step

    def restore(self, step: Optional[int], target: Any) -> Tuple[Any, int]:
        """(tree, step): `target`'s structure, each leaf read by its key
        as a tensor of the saved dtype and shape, on the device of the
        target's leaf when that is a tensor (else the CPU)."""
        manifest, step, read = self._reader(step)
        by_key = {e["key"]: e for e in manifest["entries"]}

        def leaf(key: str, tgt):
            e = by_key[key]
            t = _to_tensor(read(e), e["shape"], e["dtype"])
            return t.to(tgt.device) if isinstance(tgt, torch.Tensor) else t
        return map_with_path(leaf, target), step


__all__ = ["CheckpointManager", "CODEC", "shard_filename",
           "decompressor"]
