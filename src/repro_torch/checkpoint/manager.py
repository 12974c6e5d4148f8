"""Read and write the reference's checkpoint layout, for string-keyed
dict trees of numpy arrays.

Counterpart of the part of `repro.checkpoint.manager` that the shipped
cost model needs (`plan.serial.save_model` / `load_model`), without JAX
or the `msgpack` package.  One directory per step:

    ckpt_dir/
      step_000000123/
        manifest.msgpack      # step, hosts, codec, tree description and
                              # one entry per leaf (key, shape, dtype,
                              # offset, nbytes, shard)
        shard_00000.bin.zlib  # the leaves' bytes, concatenated in key
                              # order, zlib level 3
        COMMITTED             # written last: a step without it is torn

Keys are the reference's paths (`['a']['b']`, any characters but `'`,
so the sweep runner's `|`-joined cell keys too), so a tree written here
has the reference's manifest and shard bytes.  Writes use zlib (the
shipped artifact's codec).  Reads take the codec the manifest names,
from the reference's registry: zlib always, zstd (`shard_NNNNN.bin.zst`,
the reference's default wherever the optional `zstandard` imports) when
`zstandard` imports here too; a codec that is not available raises the
reference's `ModuleNotFoundError`, naming it.
Saves are synchronous and single-host (`wait` has nothing to join);
after each save only the newest `keep` committed steps stay, as in the
reference.
"""
from __future__ import annotations

import os
import re
import shutil
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

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


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """{path: leaf} of a string-keyed dict tree, paths as the
    reference's key strings."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        if not isinstance(k, str):
            raise TypeError(f"checkpoint trees take string keys, got {k!r}")
        path = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _treedef(tree: Dict) -> str:
    """The tree's structure as the reference's manifest records it."""
    def node(t):
        if not isinstance(t, dict):
            return "*"
        return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                               for k in sorted(t)) + "}"
    return f"PyTreeDef({node(tree)})"


class CheckpointManager:
    """Committed-step save and schema-free restore of dict trees; the
    newest `keep` committed steps survive each save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep

    def save(self, step: int, tree: Dict) -> str:
        """Write `tree` as committed step `step`; returns the step dir."""
        step_dir = os.path.join(self.dir, f"step_{step:09d}")
        os.makedirs(step_dir, exist_ok=True)
        flat = _flatten(tree)
        entries: List[Dict] = []
        payload = bytearray()
        for key in sorted(flat):
            leaf = flat[key]
            buf = leaf.tobytes()
            entries.append({"key": key, "shape": list(leaf.shape),
                            "dtype": str(leaf.dtype),
                            "offset": len(payload), "nbytes": len(buf),
                            "shard": 0})
            payload.extend(buf)
        shard_path = os.path.join(step_dir, shard_filename(0))
        with open(shard_path + ".tmp", "wb") as f:
            f.write(zlib.compress(bytes(payload), 3))
        os.replace(shard_path + ".tmp", shard_path)
        manifest = {"step": step, "n_hosts": 1, "codec": CODEC,
                    "treedef": _treedef(tree), "entries": entries}
        mpath = os.path.join(step_dir, "manifest.msgpack")
        with open(mpath + ".tmp", "wb") as f:
            f.write(packb(manifest))
        os.replace(mpath + ".tmp", mpath)
        with open(os.path.join(step_dir, "COMMITTED"), "w") as f:
            f.write(str(step))
        for old in self.committed_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{old:09d}"))
        return step_dir

    def wait(self) -> None:
        """Saves are synchronous: nothing to join."""

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

    def restore_any(self, step: Optional[int] = None) -> Tuple[Dict, int]:
        """(tree, step) rebuilt from the manifest alone: nested dicts of
        numpy arrays with the saved dtypes and shapes."""
        step_dir, step = self._step_dir(step)
        manifest = self.load_manifest(step)
        codec = manifest.get("codec", "zstd")
        decompress = decompressor(codec)     # refused before any read
        shards: Dict[int, bytes] = {}
        tree: Dict = {}
        for e in manifest["entries"]:
            key = e["key"]
            parts = _DICT_KEY.findall(key)
            if "".join(f"['{p}']" for p in parts) != key:
                raise ValueError(f"restore_any supports string-keyed dict "
                                 f"trees only; cannot rebuild node {key!r}")
            sid = e["shard"]
            if sid not in shards:
                path = os.path.join(step_dir, shard_filename(sid, codec))
                with open(path, "rb") as f:
                    shards[sid] = decompress(f.read())
            buf = shards[sid][e["offset"]:e["offset"] + e["nbytes"]]
            leaf = np.frombuffer(buf, np.dtype(e["dtype"])) \
                .reshape(e["shape"]).copy()
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
        return tree, step


__all__ = ["CheckpointManager", "CODEC", "shard_filename",
           "decompressor"]
