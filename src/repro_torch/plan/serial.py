"""Cost-model serialization in the reference's checkpoint layout.

Counterpart of the model half of `repro.plan.serial`: a
`costmodel.CostModel` becomes one string-keyed dict of numpy leaves --
the trees' node arrays concatenated (`offsets` delimits the trees) and
the scalar record MessagePack'd into a uint8 `meta` leaf -- written and
read by `repro_torch.checkpoint.CheckpointManager`.  The float64
`thresh` and `value` arrays ride as raw bytes in uint8 leaves, as the
reference stores them (its restore would truncate float64 leaves to
float32); they are read back with `np.frombuffer(..., np.float64)`, so
split thresholds and leaf values survive bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.msgpack_codec import packb, unpackb

_VERSION = 1


def _plain(v):
    """Coerce a metadata value to something MessagePack round-trips."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    return str(v)


def _f64_leaf(arr: np.ndarray) -> np.ndarray:
    """A float64 array as a uint8 leaf of its raw bytes."""
    return np.frombuffer(np.ascontiguousarray(arr, np.float64).tobytes(),
                         dtype=np.uint8).copy()


def _f64_from_leaf(leaf) -> np.ndarray:
    return np.frombuffer(np.asarray(leaf, np.uint8).tobytes(),
                         dtype=np.float64).copy()


def model_state(model) -> Dict:
    """A `costmodel.CostModel` as one checkpointable dict tree."""
    meta = {
        "version": _VERSION,
        "kind": "costmodel",
        "base": float(model.base),
        "learning_rate": float(model.learning_rate),
        "feature_names": list(model.feature_names),
        "config": _plain(dict(model.config)),
        "meta": _plain(dict(model.meta)),
    }
    trees = model.trees
    offsets = np.zeros(len(trees) + 1, dtype=np.int32)
    for i, t in enumerate(trees):
        offsets[i + 1] = offsets[i] + t.feat.shape[0]

    def cat(name, dtype):
        if not trees:
            return np.zeros(0, dtype)
        return np.concatenate([np.asarray(getattr(t, name), dtype)
                               for t in trees])

    return {
        "meta": np.frombuffer(packb(meta), dtype=np.uint8).copy(),
        "offsets": offsets,
        "feat": cat("feat", np.int32),
        "left": cat("left", np.int32),
        "right": cat("right", np.int32),
        "thresh": _f64_leaf(cat("thresh", np.float64)),
        "value": _f64_leaf(cat("value", np.float64)),
    }


def model_from_state(state: Dict):
    """Rebuild a `costmodel.CostModel` from `model_state` output."""
    from .costmodel import CostModel, _Tree

    meta = unpackb(np.asarray(state["meta"], np.uint8).tobytes())
    if meta["version"] != _VERSION or meta.get("kind") != "costmodel":
        raise ValueError(f"not a cost-model state: {meta.get('kind')!r} "
                         f"v{meta.get('version')!r}")
    offsets = np.asarray(state["offsets"], dtype=np.int64)
    thresh = _f64_from_leaf(state["thresh"])
    value = _f64_from_leaf(state["value"])
    trees = []
    for i in range(offsets.shape[0] - 1):
        lo, hi = int(offsets[i]), int(offsets[i + 1])
        trees.append(_Tree(
            feat=np.asarray(state["feat"][lo:hi], np.int32),
            thresh=thresh[lo:hi].copy(),
            left=np.asarray(state["left"][lo:hi], np.int32),
            right=np.asarray(state["right"][lo:hi], np.int32),
            value=value[lo:hi].copy()))
    return CostModel(base=float(meta["base"]),
                     learning_rate=float(meta["learning_rate"]),
                     trees=tuple(trees),
                     feature_names=tuple(meta["feature_names"]),
                     config=meta.get("config", {}),
                     meta=meta.get("meta", {}))


def save_model(model, ckpt_dir: str, step: int = 0) -> str:
    """Write a cost model as a committed checkpoint step (zlib, as the
    shipped artifact).  Returns the step directory."""
    return CheckpointManager(ckpt_dir).save(step, model_state(model))


def load_model(ckpt_dir: str, step: Optional[int] = None):
    """(model, step) from a checkpoint written by `save_model` -- or by
    the reference's."""
    state, step = CheckpointManager(ckpt_dir).restore_any(step)
    return model_from_state(state), step


__all__ = ["model_state", "model_from_state", "save_model", "load_model"]
