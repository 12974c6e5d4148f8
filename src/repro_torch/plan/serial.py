"""Plan and cost-model serialization in the reference's checkpoint
layout (counterpart of `repro.plan.serial`).

A plan becomes one string-keyed dict of numpy leaves -- the container's
arrays, the permutations, a sharded plan's slabs and the retained CSR,
each byte-equal to the reference's for the same plan -- plus one uint8
`meta` leaf: the decision record (format, knobs, structure report,
predicted scores, compile stats) MessagePack'd by the port's own codec.
`repro_torch.checkpoint.CheckpointManager` writes and reads it, so a
plan saved by either package loads in the other.  The kernel layout is
not stored: `load_plan` rebuilds it from the container and the recorded
knobs.  A device mesh is never stored: pass `mesh=` to `load_plan` to
rebind a row-sharded plan.

The knobs are the reference's (`bn`, `bm`, `n_stripes`, `seg_len`).
The port's padded CSR uses `bm` and `n_stripes`; the others name TPU
tiles its layouts do not have, so they are written as the reference's
defaults and ignored on load, and a segmented layout's merge-path
window is recorded as `window` only when it is not the default.

A cost model becomes the trees' node arrays concatenated (`offsets`
delimits the trees) and the scalar record in `meta`.  The float64
`thresh` and `value` arrays ride as raw bytes in uint8 leaves, as the
reference stores them (its restore would truncate float64 leaves to
float32), so split thresholds and leaf values survive bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.msgpack_codec import packb, unpackb
from repro_torch.core.formats import BELL, CSR, DIA, ELL, HYB
from repro_torch.device import resolve_device, to_numpy, to_tensor
from repro_torch.kernels import _layout as kl
from repro_torch.kernels.spmv_csr_seg import WINDOW

_VERSION = 1

# the reference's layout knobs the port's layouts have no use for,
# written as the reference's defaults: DIA's row block, the ELL row
# block and the segment length of its segmented CSR
_REFERENCE_BN = 512
_REFERENCE_BM = 128
_REFERENCE_SEG_LEN = 512


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


def _prep_knobs(plan) -> Dict:
    """The layout knobs in the reference's vocabulary, enough for either
    package to rebuild its own layout at load."""
    p = plan.prep
    if p is None:
        return {}
    if isinstance(p, kl.PreparedDIA):
        return {"bn": _REFERENCE_BN}
    if isinstance(p, kl.PreparedELL):
        return {"bm": _REFERENCE_BM}
    if isinstance(p, kl.PaddedCSR):
        return {"bm": p.bm, "n_stripes": int(p.vals.shape[0])}
    if isinstance(p, kl.PreparedSegCSR):
        window = p.window
        knobs = {"seg_len": _REFERENCE_SEG_LEN}
    elif isinstance(p, kl.PreparedHYB):
        window = p.heavy.window
        knobs = {"seg_len": _REFERENCE_SEG_LEN, "bm": _REFERENCE_BM}
    else:
        return {}
    if window != WINDOW:
        knobs["window"] = window
    return knobs


def _arrays(**tensors) -> Dict[str, np.ndarray]:
    return {k: to_numpy(v) for k, v in tensors.items()}


def plan_state(plan) -> Dict:
    """The plan as one checkpointable dict tree of numpy leaves."""
    meta = {
        "version": _VERSION,
        "fingerprint": plan.fingerprint,
        "format_name": plan.format_name,
        "threads": plan.threads,
        "use_pallas": plan.use_pallas,
        "interpret": None,
        "semiring": plan.semiring,
        "chosen": plan.chosen,
        "predicted": _plain(plan.predicted),
        "compile_stats": _plain(plan.compile_stats),
        "prep_knobs": _prep_knobs(plan),
        "has_csr": plan.csr is not None,
        "report": (_plain(dataclasses.asdict(plan.report))
                   if plan.report is not None else None),
    }
    state: Dict = {}

    c = plan.container
    if isinstance(c, DIA):
        meta["container"] = {"type": "dia", "n_rows": c.n_rows,
                             "n_cols": c.n_cols}
        state["container"] = _arrays(data=c.data, offsets=c.offsets)
    elif isinstance(c, BELL):
        meta["container"] = {"type": "bell", "n_rows": c.n_rows,
                             "n_cols": c.n_cols, "bm": c.bm, "bn": c.bn,
                             "blocks_per_row": c.blocks_per_row}
        state["container"] = _arrays(data=c.data, block_cols=c.block_cols)
    elif isinstance(c, ELL):
        meta["container"] = {"type": "ell", "n_rows": c.n_rows,
                             "n_cols": c.n_cols, "max_nnz": c.max_nnz}
        state["container"] = _arrays(data=c.data, indices=c.indices)
    elif isinstance(c, HYB):
        meta["container"] = {"type": "hyb", "n_rows": c.n_rows,
                             "n_cols": c.n_cols, "threshold": c.threshold,
                             "light_width": c.light_width}
        state["container"] = _arrays(data=c.data, indices=c.indices,
                                     hvals=c.hvals, hrows=c.hrows,
                                     hcols=c.hcols)
    elif isinstance(c, CSR) or c is None:
        # a CSR container is stored once, under "csr" (below)
        meta["container"] = {"type": "csr" if isinstance(c, CSR) else None}
        if isinstance(c, CSR) and plan.csr is None:
            state["csr"] = _arrays(data=c.data, indices=c.indices,
                                   indptr=c.indptr)
            meta["csr_shape"] = [c.n_rows, c.n_cols]
    else:
        raise TypeError(f"unserializable container: {type(c)}")

    if plan.format_name == "ell-sharded":
        p = plan.prep
        meta["sharded"] = {"n_rows": p.n_rows, "n_cols": p.n_cols,
                           "bm": p.bm}
        state["sharded"] = {"data": p.data, "idx": p.idx,
                            "starts": np.asarray(p.starts)}

    if plan.reordering is not None:
        r = plan.reordering
        meta["reorder"] = {"strategy": r.strategy,
                           "params": _plain(r.params),
                           "stats": _plain(r.stats)}
        state["reorder"] = {"row_perm": np.asarray(r.row_perm),
                            "col_perm": np.asarray(r.col_perm)}

    if plan.csr is not None:
        meta["csr_shape"] = [plan.csr.n_rows, plan.csr.n_cols]
        state["csr"] = _arrays(data=plan.csr.data,
                               indices=plan.csr.indices,
                               indptr=plan.csr.indptr)

    state["meta"] = np.frombuffer(packb(meta), dtype=np.uint8).copy()
    return state


def plan_from_state(state: Dict, mesh=None, device=None):
    """Rebuild an `SpmvPlan` from `plan_state` output (as
    `CheckpointManager.restore_any` gives it) on `device` (None: the
    mesh's first device with `mesh=`, else the card)."""
    from repro_torch.graph.semiring import resolve

    from .compiler import _prepare
    from .plan import SpmvPlan

    meta = unpackb(np.asarray(state["meta"], np.uint8).tobytes())
    if meta["version"] != _VERSION:
        raise ValueError(f"unknown plan state version {meta['version']}")
    if mesh is not None and device is None:
        device = mesh.devices[0]
    dev = resolve_device(device)
    semiring = meta.get("semiring", "plus_times")
    fill = resolve(semiring).pad_value

    def on(g, *names):
        return [to_tensor(np.asarray(g[n]), dev) for n in names]

    csr = None
    if "csr" in state:
        n_rows, n_cols = meta["csr_shape"]
        data, indices, indptr = on(state["csr"], "data", "indices",
                                   "indptr")
        csr = CSR(data=data, indices=indices, indptr=indptr,
                  n_rows=int(n_rows), n_cols=int(n_cols))

    cmeta = meta["container"]
    ctype = cmeta["type"] if cmeta else None
    g = state.get("container")
    if ctype == "dia":
        data, offsets = on(g, "data", "offsets")
        container = DIA(data=data, offsets=offsets,
                        n_rows=int(cmeta["n_rows"]),
                        n_cols=int(cmeta["n_cols"]))
    elif ctype == "bell":
        data, block_cols = on(g, "data", "block_cols")
        container = BELL(data=data, block_cols=block_cols,
                         n_rows=int(cmeta["n_rows"]),
                         n_cols=int(cmeta["n_cols"]), bm=int(cmeta["bm"]),
                         bn=int(cmeta["bn"]),
                         blocks_per_row=int(cmeta["blocks_per_row"]))
    elif ctype == "ell":
        data, indices = on(g, "data", "indices")
        container = ELL(data=data, indices=indices,
                        n_rows=int(cmeta["n_rows"]),
                        n_cols=int(cmeta["n_cols"]),
                        max_nnz=int(cmeta["max_nnz"]), fill=fill)
    elif ctype == "hyb":
        data, indices, hvals, hrows, hcols = on(
            g, "data", "indices", "hvals", "hrows", "hcols")
        container = HYB(data=data, indices=indices, hvals=hvals,
                        hrows=hrows, hcols=hcols,
                        n_rows=int(cmeta["n_rows"]),
                        n_cols=int(cmeta["n_cols"]),
                        threshold=int(cmeta["threshold"]),
                        light_width=int(cmeta["light_width"]), fill=fill)
    elif ctype == "csr":
        container = csr
    else:
        container = None

    reordering = None
    if "reorder" in state:
        from repro_torch.reorder import Reordering

        rmeta = meta["reorder"]
        reordering = Reordering(
            row_perm=np.asarray(state["reorder"]["row_perm"]),
            col_perm=np.asarray(state["reorder"]["col_perm"]),
            strategy=rmeta["strategy"], params=rmeta.get("params", {}),
            stats=rmeta.get("stats", {}))

    format_name = meta["format_name"]
    if format_name == "ell-sharded":
        g = state["sharded"]
        smeta = meta["sharded"]
        prep = kl.ShardedELL(
            data=np.asarray(g["data"]), idx=np.asarray(g["idx"]),
            n_rows=int(smeta["n_rows"]), n_cols=int(smeta["n_cols"]),
            starts=np.asarray(g["starts"], dtype=np.int64),
            bm=int(smeta["bm"]))
        if mesh is not None:
            prep.slabs(mesh.devices)
    elif meta["use_pallas"] and container is not None:
        knobs = meta.get("prep_knobs", {})
        prep = _prepare(container, format_name,
                        bm=int(knobs.get("bm", _REFERENCE_BM)),
                        n_stripes=int(knobs.get("n_stripes", 1)),
                        seg_len=int(knobs.get("window", WINDOW)),
                        semiring=resolve(semiring))
    else:
        prep = None

    report = None
    if meta.get("report") is not None:
        from repro_torch.core.structure import StructureReport

        report = StructureReport(**meta["report"])

    return SpmvPlan(
        fingerprint=meta["fingerprint"], format_name=format_name,
        container=container, prep=prep, device=dev, reordering=reordering,
        report=report, csr=csr, threads=int(meta["threads"]),
        use_pallas=bool(meta["use_pallas"]), semiring=semiring,
        predicted=meta.get("predicted", {}),
        chosen=meta.get("chosen", "none"),
        compile_stats=meta.get("compile_stats", {}), mesh=mesh)


def save_plan(plan, ckpt_dir: str, step: int = 0,
              manager: Optional[CheckpointManager] = None) -> str:
    """Write the plan as a committed checkpoint step (zlib).  Returns the
    step directory."""
    mgr = manager if manager is not None else CheckpointManager(ckpt_dir)
    return mgr.save(step, plan_state(plan))


def load_plan(ckpt_dir: str, step: Optional[int] = None, mesh=None,
              device=None) -> Tuple[object, int]:
    """(plan, step) from a checkpoint written by `save_plan` -- or by the
    reference's, under zlib or (where `zstandard` imports) its default
    zstd.  `mesh=` rebinds a row-sharded plan; `device` as in
    `plan_from_state`."""
    state, step = CheckpointManager(ckpt_dir).restore_any(step)
    return plan_from_state(state, mesh=mesh, device=device), step


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


__all__ = ["plan_state", "plan_from_state", "save_plan", "load_plan",
           "model_state", "model_from_state", "save_model", "load_model"]
