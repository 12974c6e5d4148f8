"""Learned cost model: structural features -> predicted SpMV throughput.

Counterpart of `repro.plan.costmodel`, host-side numpy as there.  A
small gradient-boosted ensemble of regression trees maps a candidate's
`structure.analyze` report plus geometry and thread count to the
predicted contended-LLC throughput (log2 GFLOPS) of the Sandy Bridge
replay oracle, so `plan.compile` scores (format, reordering) candidates
in microseconds.

Parity with the reference is bitwise: `features_for` computes each
feature with Python floats in the reference's order, `_Tree.predict`
walks the float64 thresholds with `<=`, the ensemble sums in tree
order, and `fit` on the port's copy of the corpus reproduces the
shipped model byte for byte (`model_bytes`, encoded by the port's own
MessagePack codec).  The port reads only its own copy of the artifact
and corpus, under `repro_torch/plan/_data/`.  The replay oracle stays
as the fallback scorer and labels the corpus (`run_label_cell`
mirrors the compiler's replay branch), harvested through the sweep
runner (`harvest`, sharded and resumable like any sweep).

    python -m repro_torch.plan.costmodel --harvest --corpus corpus.json \
        --ckpt /tmp/labels            # replay-label the grid
    python -m repro_torch.plan.costmodel --fit --corpus corpus.json \
        --out DIR                     # deterministic refit
    python -m repro_torch.plan.costmodel --eval --corpus corpus.json
    python -m repro_torch.plan.costmodel --check    # refit == shipped
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint.msgpack_codec import packb
from repro_torch.core.cache_model import SANDY_BRIDGE, MachineModel
from repro_torch.core.structure import StructureReport

_VERSION = 1

# ---------------------------------------------------------------------------
# Features: one vector per (candidate structure, geometry, thread count)
# ---------------------------------------------------------------------------
# Counts and byte sizes enter as log2(v + 1) so trees split on orders of
# magnitude; the locality fractions and nnz/row dispersion enter raw.
# The candidate's *permuted* report is featurized -- the model scores
# exactly the stream the chosen format will exploit, the same contract
# the replay oracle has.

FEATURE_NAMES: Tuple[str, ...] = (
    "log2_rows", "log2_nnz", "avg_nnz_per_row", "row_nnz_cv",
    "log2_bandwidth", "log2_bandwidth_p95", "log2_distinct_offsets",
    "log2_band_groups", "spatial_locality", "temporal_locality",
    "stream_servable", "block_density_8x128",
    "kind_banded", "kind_blocked", "kind_unstructured",
    "log2_threads", "log2_nnz_per_thread",
    "log2_l2_bytes", "log2_llc_bytes",
)


def _lg(v) -> float:
    return math.log2(max(float(v), 0.0) + 1.0)


def features_for(report: StructureReport, threads: int = 1, *,
                 l2_bytes: Optional[int] = None,
                 llc_bytes: Optional[int] = None,
                 machine: MachineModel = SANDY_BRIDGE) -> np.ndarray:
    """Feature vector (float64, `FEATURE_NAMES` order) for one candidate.

    `l2_bytes`/`llc_bytes` take the simulated geometry when the caller
    scores a scaled cell (`ParallelSpec(l2_bytes=..., llc_bytes=...)`);
    `None` falls back to the machine's real private-L2 / shared-L3 sizes,
    matching `ParallelSpec`'s own defaulting.
    """
    t = max(int(threads), 1)
    l2 = float(l2_bytes) if l2_bytes else float(machine.l2_bytes)
    llc = float(llc_bytes) if llc_bytes else float(machine.l3_bytes)
    return np.array([
        _lg(report.n_rows), _lg(report.nnz),
        float(report.avg_nnz_per_row), float(report.row_nnz_cv),
        _lg(report.bandwidth), _lg(report.bandwidth_p95),
        _lg(report.n_distinct_offsets), _lg(report.n_band_groups),
        float(report.spatial_locality), float(report.temporal_locality),
        float(report.stream_servable), float(report.block_density_8x128),
        1.0 if report.kind == "banded" else 0.0,
        1.0 if report.kind == "blocked" else 0.0,
        1.0 if report.kind == "unstructured" else 0.0,
        math.log2(t), _lg(report.nnz / t),
        math.log2(l2), math.log2(llc),
    ], dtype=np.float64)


# ---------------------------------------------------------------------------
# Regression trees + gradient boosting (numpy, exact greedy, deterministic)
# ---------------------------------------------------------------------------

DEFAULT_CONFIG: Dict[str, float] = {
    "n_trees": 150, "max_depth": 3, "learning_rate": 0.1,
    "min_leaf": 2, "seed": 0,
}


@dataclasses.dataclass(frozen=True)
class _Tree:
    """One regression tree as parallel node arrays (feat < 0 marks a
    leaf; children index into the same arrays)."""

    feat: np.ndarray      # int32 (n_nodes,)
    thresh: np.ndarray    # float64
    left: np.ndarray      # int32
    right: np.ndarray     # int32
    value: np.ndarray     # float64

    def predict(self, X: np.ndarray) -> np.ndarray:
        node = np.zeros(X.shape[0], dtype=np.int32)
        for _ in range(64):                      # depth-bounded walk
            f = self.feat[node]
            active = f >= 0
            if not active.any():
                break
            rows = np.nonzero(active)[0]
            goes_left = X[rows, f[rows]] <= self.thresh[node[rows]]
            nxt = np.where(goes_left, self.left[node[rows]],
                           self.right[node[rows]])
            node = node.copy()
            node[rows] = nxt
        return self.value[node]


def _fit_tree(X: np.ndarray, y: np.ndarray, max_depth: int,
              min_leaf: int) -> _Tree:
    """Exact greedy least-squares tree.  Deterministic: features scanned
    in index order, stable sorts, a split must *strictly* beat the
    incumbent (first feature / first threshold wins ties)."""
    nodes: List[Tuple[int, float, int, int, float]] = []

    def build(idx: np.ndarray, depth: int) -> int:
        i = len(nodes)
        nodes.append((-1, 0.0, -1, -1, 0.0))     # placeholder
        ysub = y[idx]
        val = float(ysub.mean())
        best = None                              # (gain, feat, thr, lidx, ridx)
        if depth < max_depth and idx.size >= 2 * min_leaf:
            sse_parent = float(((ysub - val) ** 2).sum())
            n = idx.size
            for f in range(X.shape[1]):
                xs = X[idx, f]
                order = np.argsort(xs, kind="stable")
                xo, yo = xs[order], ysub[order]
                csum = np.cumsum(yo)
                csq = np.cumsum(yo * yo)
                p = np.arange(1, n)
                valid = (xo[1:] != xo[:-1]) & (p >= min_leaf) \
                    & (n - p >= min_leaf)
                if not valid.any():
                    continue
                pl = p[valid]
                nl = pl.astype(np.float64)
                nr = float(n) - nl
                sl, sql = csum[pl - 1], csq[pl - 1]
                sse = (sql - sl * sl / nl) \
                    + ((csq[-1] - sql) - (csum[-1] - sl) ** 2 / nr)
                j = int(np.argmin(sse))          # first minimum wins
                gain = sse_parent - float(sse[j])
                if gain > 1e-12 and (best is None or gain > best[0] + 1e-12):
                    cut = int(pl[j])
                    thr = 0.5 * (float(xo[cut - 1]) + float(xo[cut]))
                    best = (gain, f, thr, idx[order[:cut]], idx[order[cut:]])
            del n
        if best is None:
            nodes[i] = (-1, 0.0, -1, -1, val)
        else:
            _, f, thr, lidx, ridx = best
            lchild = build(lidx, depth + 1)
            rchild = build(ridx, depth + 1)
            nodes[i] = (f, thr, lchild, rchild, val)
        return i

    build(np.arange(y.shape[0]), 0)
    feat, thr, left, right, value = zip(*nodes)
    return _Tree(feat=np.asarray(feat, np.int32),
                 thresh=np.asarray(thr, np.float64),
                 left=np.asarray(left, np.int32),
                 right=np.asarray(right, np.int32),
                 value=np.asarray(value, np.float64))


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Gradient-boosted ensemble over `FEATURE_NAMES`, predicting
    log2(GFLOPS) of the contended-LLC replay oracle."""

    base: float
    learning_rate: float
    trees: Tuple[_Tree, ...]
    feature_names: Tuple[str, ...] = FEATURE_NAMES
    config: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_CONFIG))
    meta: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def predict(self, X) -> np.ndarray:
        """log2-GFLOPS predictions for feature rows `X` (n, n_features)."""
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        if X.shape[1] != len(self.feature_names):
            raise ValueError(
                f"feature mismatch: model wants {len(self.feature_names)} "
                f"features, got {X.shape[1]}")
        out = np.full(X.shape[0], self.base, dtype=np.float64)
        for t in self.trees:
            out += self.learning_rate * t.predict(X)
        return out

    def predict_gflops(self, report: StructureReport, threads: int = 1, *,
                       l2_bytes: Optional[int] = None,
                       llc_bytes: Optional[int] = None,
                       machine: MachineModel = SANDY_BRIDGE) -> float:
        """Predicted throughput for one candidate structure (the
        `plan.compile` fast-path entry)."""
        f = features_for(report, threads, l2_bytes=l2_bytes,
                         llc_bytes=llc_bytes, machine=machine)
        return float(2.0 ** self.predict(f[None, :])[0])


def fit(rows: Sequence["LabelPoint"],
        config: Optional[Mapping[str, float]] = None) -> CostModel:
    """Deterministic refit from a label corpus.  The label is
    log2(GFLOPS): multiplicative throughput error is what candidate
    *ranking* cares about, and the margin rule operates on ratios."""
    cfg = dict(DEFAULT_CONFIG)
    if config:
        cfg.update(config)
    if not rows:
        raise ValueError("empty corpus")
    X = np.asarray([r.features for r in rows], dtype=np.float64)
    if X.shape[1] != len(FEATURE_NAMES):
        raise ValueError(
            f"corpus features have width {X.shape[1]}, expected "
            f"{len(FEATURE_NAMES)} (a stale corpus?)")
    y = np.log2(np.maximum([r.gflops for r in rows], 1e-12))
    base = float(y.mean())
    pred = np.full(y.shape, base)
    trees: List[_Tree] = []
    for _ in range(int(cfg["n_trees"])):
        t = _fit_tree(X, y - pred, int(cfg["max_depth"]),
                      int(cfg["min_leaf"]))
        pred += float(cfg["learning_rate"]) * t.predict(X)
        trees.append(t)
    meta = {"n_rows": len(rows), "corpus_digest": corpus_digest(rows),
            "label": "log2_gflops"}
    return CostModel(base=base, learning_rate=float(cfg["learning_rate"]),
                     trees=tuple(trees), feature_names=FEATURE_NAMES,
                     config=cfg, meta=meta)


# ---------------------------------------------------------------------------
# Canonical bytes + digest
# ---------------------------------------------------------------------------


def model_bytes(model: CostModel) -> bytes:
    """Canonical MessagePack encoding (fixed key order, float64 exact),
    the reference's bytes for the same model."""
    payload = {
        "version": _VERSION,
        "feature_names": list(model.feature_names),
        "config": [[k, model.config[k]] for k in sorted(model.config)],
        "base": float(model.base),
        "learning_rate": float(model.learning_rate),
        "meta": [[k, model.meta[k]] for k in sorted(model.meta)],
        "trees": [{
            "feat": t.feat.tolist(), "thresh": t.thresh.tolist(),
            "left": t.left.tolist(), "right": t.right.tolist(),
            "value": t.value.tolist(),
        } for t in model.trees],
    }
    return packb(payload)


def model_digest(model: CostModel) -> str:
    return hashlib.blake2b(model_bytes(model), digest_size=16).hexdigest()


# ---------------------------------------------------------------------------
# Labeling: replay-oracle corpus rows
# ---------------------------------------------------------------------------

# Simulated-geometry axis of the label cells.
LABEL_SPECS: Dict[str, Dict[str, Optional[int]]] = {
    "default": {"l2_bytes": None, "llc_bytes": None},
    "scaled": {"l2_bytes": 16 * 1024, "llc_bytes": 64 * 1024},
}

LABEL_KINDS = ("banded", "fd", "rmat", "scrambled", "uniform")


@dataclasses.dataclass(frozen=True)
class LabelPoint:
    """One labeled corpus row: the feature vector of a (matrix, reorder,
    threads, geometry) candidate and its replay-oracle throughput."""

    kind: str
    log2n: int
    seed: int
    reorder: str
    threads: int
    spec: str                     # LABEL_SPECS key
    nnz: int
    gflops: float                 # ParallelMetrics.gflops_est() (the label)
    time_s: float
    features: Tuple[float, ...]   # FEATURE_NAMES order


def label_matrix(kind: str, n: int, seed: int, device=None):
    """Deterministic matrix for a label cell, on `device` (None: the
    card).  'scrambled' is a banded matrix under a random symmetric
    permutation -- the case where RCM recovers the band and reordering
    genuinely wins."""
    from repro_torch.core.generators import (banded_matrix, fd_matrix,
                                             rmat_matrix,
                                             uniform_random_matrix)

    if kind == "fd":
        return fd_matrix(n, seed=seed, device=device)
    if kind == "rmat":
        return rmat_matrix(n, seed=seed, device=device)
    if kind == "uniform":
        return uniform_random_matrix(n, seed=seed, device=device)
    if kind in ("banded", "scrambled"):
        csr = banded_matrix(n, bandwidth=max(8, n // 32), seed=seed,
                            device=device)
        if kind == "banded":
            return csr
        from repro_torch.reorder import Reordering

        perm = np.random.default_rng(seed + 9173).permutation(n) \
            .astype(np.int64)
        scramble = Reordering(row_perm=perm, col_perm=perm,
                              strategy="scramble", params={}, stats={})
        return scramble.apply(csr)
    raise ValueError(f"unknown label kind {kind!r}")


def run_label_cell(kind: str, log2n: int, reorder: str, threads: int,
                   spec_label: str = "scaled", *,
                   machine: MachineModel = SANDY_BRIDGE, seed: int = 0,
                   sweeps: int = 2, device=None) -> LabelPoint:
    """Execute one label cell (pure, deterministic): permute, featurize
    the permuted structure, replay the permuted stream.  This mirrors
    `plan.compiler._predict`'s replay branch exactly, so the corpus
    labels are the same numbers `predictor='replay'` would score."""
    from repro_torch.core import structure
    from repro_torch.core.partition import rowblock_balanced
    from repro_torch.parallel import ParallelSpec, simulate_parallel
    from repro_torch.reorder import STRATEGIES

    geo = LABEL_SPECS[spec_label]
    spec = ParallelSpec(l2_bytes=geo["l2_bytes"], llc_bytes=geo["llc_bytes"])
    csr = label_matrix(kind, 2 ** log2n, seed, device=device)
    r = STRATEGIES[reorder](csr) if reorder != "none" else None
    perm = r.apply(csr) if r is not None else csr
    rep = structure.analyze(perm)
    feats = features_for(rep, threads, l2_bytes=geo["l2_bytes"],
                         llc_bytes=geo["llc_bytes"], machine=machine)
    part = rowblock_balanced(perm, threads)
    _, m = simulate_parallel(perm, part, machine, spec, sweeps=sweeps)
    return LabelPoint(kind=kind, log2n=int(log2n), seed=int(seed),
                      reorder=reorder, threads=int(threads), spec=spec_label,
                      nnz=int(perm.nnz), gflops=float(m.gflops_est()),
                      time_s=float(m.time_s),
                      features=tuple(float(v) for v in feats))


def label_cells(kinds: Sequence[str] = LABEL_KINDS,
                log2ns: Sequence[int] = (8, 9, 10),
                threads_list: Sequence[int] = (1, 2, 4, 8),
                reorders: Sequence[str] = ("none", "rcm"),
                specs: Sequence[str] = ("default", "scaled")) -> List:
    """The label grid as runner `SweepCell`s (sweep='label'; the spec
    label rides the free `mechanism` field).  Seeds are not a cell axis:
    they come from `SweepConfig.seed`, one `execute_cells` pass each."""
    from repro_torch.telemetry.runner import SweepCell, sort_cells

    return sort_cells([
        SweepCell(sweep="label", kind=k, log2n=int(n), reorder=r,
                  threads=int(t), mechanism=s)
        for k in kinds for n in log2ns for r in reorders
        for t in threads_list for s in specs])


def harvest(kinds: Sequence[str] = LABEL_KINDS,
            log2ns: Sequence[int] = (8, 9, 10),
            threads_list: Sequence[int] = (1, 2, 4, 8),
            reorders: Sequence[str] = ("none", "rcm"),
            specs: Sequence[str] = ("default", "scaled"),
            seeds: Sequence[int] = (0, 1, 2),
            workers: int = 1, ckpt_dir: Optional[str] = None,
            sweeps: int = 2, device=None) -> List[LabelPoint]:
    """Replay-label the grid through the sharded resumable runner, one
    checkpointed pass per seed (`ckpt_dir/seed<N>`), the matrices made
    on `device` (None: the card)."""
    from repro_torch.telemetry.runner import (SweepConfig, device_name,
                                              execute_cells)

    cells = label_cells(kinds, log2ns, threads_list, reorders, specs)
    rows: List[LabelPoint] = []
    for seed in seeds:
        cfg = SweepConfig(seed=int(seed), sweeps=sweeps,
                          device=device_name(device))
        sub = os.path.join(ckpt_dir, f"seed{seed}") if ckpt_dir else None
        rows.extend(execute_cells(cells, cfg, workers=workers,
                                  ckpt_dir=sub))
    return sort_rows(rows)


# ---------------------------------------------------------------------------
# Corpus I/O: canonical JSON (exact float round-trip, sorted keys)
# ---------------------------------------------------------------------------


def sort_rows(rows: Sequence[LabelPoint]) -> List[LabelPoint]:
    return sorted(rows, key=lambda r: (r.kind, r.log2n, r.seed, r.spec,
                                       r.reorder, r.threads))


def save_corpus(rows: Sequence[LabelPoint], path: str) -> None:
    doc = {"version": _VERSION, "feature_names": list(FEATURE_NAMES),
           "rows": [dataclasses.asdict(r) for r in sort_rows(rows)]}
    blob = json.dumps(doc, sort_keys=True, indent=1)
    with open(path, "w") as f:
        f.write(blob + "\n")


def load_corpus(path: str) -> List[LabelPoint]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("version") != _VERSION:
        raise ValueError(f"unknown corpus version {doc.get('version')!r}")
    names = tuple(doc.get("feature_names", ()))
    if names != FEATURE_NAMES:
        raise ValueError(
            "corpus feature names do not match this build's FEATURE_NAMES; "
            "harvest it again")
    return [LabelPoint(kind=d["kind"], log2n=int(d["log2n"]),
                       seed=int(d["seed"]), reorder=d["reorder"],
                       threads=int(d["threads"]), spec=d["spec"],
                       nnz=int(d["nnz"]), gflops=float(d["gflops"]),
                       time_s=float(d["time_s"]),
                       features=tuple(float(v) for v in d["features"]))
            for d in doc["rows"]]


def corpus_digest(rows: Sequence[LabelPoint]) -> str:
    blob = json.dumps([dataclasses.asdict(r) for r in sort_rows(rows)],
                      sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


# ---------------------------------------------------------------------------
# Evaluation: does the model pick the replay winner?
# ---------------------------------------------------------------------------


def pick_winner(scores: Mapping[str, float]) -> str:
    """The compiler's candidate-selection rule over reorder labels:
    sorted order, strict > to displace, and a reordered winner must beat
    'none' by `REORDER_MARGIN` (transport overhead bar)."""
    from .compiler import REORDER_MARGIN

    ordered = sorted(scores)
    chosen = ordered[0]
    for lab in ordered[1:]:
        if scores[lab] > scores[chosen]:
            chosen = lab
    if chosen != "none" and "none" in scores:
        if scores[chosen] <= scores["none"] * (1.0 + REORDER_MARGIN):
            chosen = "none"
    return chosen


def evaluate(model: CostModel, rows: Sequence[LabelPoint]) -> Dict:
    """Agreement of model-picked vs replay-picked reordering per cell
    group (kind, log2n, seed, spec, threads), plus regression quality."""
    X = np.asarray([r.features for r in rows], dtype=np.float64)
    y = np.log2(np.maximum([r.gflops for r in rows], 1e-12))
    yhat = model.predict(X)
    groups: Dict[Tuple, Dict[str, Tuple[float, float]]] = {}
    for r, t, p in zip(rows, y, yhat):
        gk = (r.kind, r.log2n, r.seed, r.spec, r.threads)
        groups.setdefault(gk, {})[r.reorder] = (2.0 ** t, 2.0 ** p)
    n_groups = agree = 0
    by_kind: Dict[str, List[int]] = {}
    for gk, cand in groups.items():
        if len(cand) < 2:
            continue
        n_groups += 1
        w_true = pick_winner({k: v[0] for k, v in cand.items()})
        w_pred = pick_winner({k: v[1] for k, v in cand.items()})
        ok = int(w_true == w_pred)
        agree += ok
        by_kind.setdefault(gk[0], []).append(ok)
    resid = y - yhat
    ss_res = float((resid ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    return {
        "n_rows": len(rows), "n_groups": n_groups,
        "agreement": agree / n_groups if n_groups else 1.0,
        "mae_log2": float(np.abs(resid).mean()),
        "r2": 1.0 - ss_res / ss_tot if ss_tot else 1.0,
        "by_kind": {k: sum(v) / len(v) for k, v in sorted(by_kind.items())},
    }


# ---------------------------------------------------------------------------
# The shipped default model (what `plan.compile(predictor='auto')` uses)
# ---------------------------------------------------------------------------

DEFAULT_MODEL_DIR = os.path.join(os.path.dirname(__file__), "_data",
                                 "costmodel")
_UNSET = object()
_default_model = _UNSET


def default_model() -> Optional[CostModel]:
    """The shipped model (the port's copy under `_data/costmodel`),
    loaded lazily once per process; None when it cannot be loaded, and
    callers then score with the oracle, as in the reference."""
    global _default_model
    if _default_model is _UNSET:
        try:
            from .serial import load_model

            _default_model = load_model(DEFAULT_MODEL_DIR)[0]
        except Exception:
            _default_model = None
    return _default_model


def set_default_model(model: Optional[CostModel]):
    """Swap the process default (tests use this to force fallback or pin
    a fixture model).  Returns the previous value; pass the sentinel-free
    previous value back to restore."""
    global _default_model
    prev = None if _default_model is _UNSET else _default_model
    _default_model = model
    return prev


# ---------------------------------------------------------------------------
# CLI: harvest / fit / eval / check
# ---------------------------------------------------------------------------

DEFAULT_CORPUS = os.path.join(os.path.dirname(__file__), "_data",
                              "costmodel_corpus.json")


def _int_list(s: str) -> List[int]:
    return [int(v) for v in s.split(",") if v]


def _str_list(s: str) -> List[str]:
    return [v for v in s.split(",") if v]


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="learned plan-compiler cost model: harvest replay "
                    "labels, fit, evaluate, or verify the shipped artifact")
    ap.add_argument("--harvest", action="store_true",
                    help="replay-label the grid into --corpus")
    ap.add_argument("--fit", action="store_true",
                    help="deterministic refit from --corpus into --out")
    ap.add_argument("--eval", action="store_true",
                    help="agreement/regression metrics of --model on --corpus")
    ap.add_argument("--check", action="store_true",
                    help="refit from --corpus and byte-compare against the "
                         "shipped artifact (exit 1 on drift)")
    ap.add_argument("--corpus", default=DEFAULT_CORPUS)
    ap.add_argument("--out", default=DEFAULT_MODEL_DIR,
                    help="checkpoint directory the fitted model is saved to")
    ap.add_argument("--model", default=DEFAULT_MODEL_DIR,
                    help="checkpoint directory --eval loads from")
    ap.add_argument("--kinds", default=",".join(LABEL_KINDS))
    ap.add_argument("--log2ns", default="8,9,10")
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--reorders", default="none,rcm")
    ap.add_argument("--specs", default="default,scaled")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--sweeps", type=int, default=2)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--ckpt", default=None,
                    help="harvest checkpoint directory (resumable)")
    ap.add_argument("--device", default=None,
                    help="where --harvest makes its matrices, e.g. cuda or "
                         "cpu (default: the card)")
    args = ap.parse_args(argv)

    if not (args.harvest or args.fit or args.eval or args.check):
        ap.error("pick at least one of --harvest/--fit/--eval/--check")

    if args.harvest:
        rows = harvest(kinds=_str_list(args.kinds),
                       log2ns=_int_list(args.log2ns),
                       threads_list=_int_list(args.threads),
                       reorders=_str_list(args.reorders),
                       specs=_str_list(args.specs),
                       seeds=_int_list(args.seeds),
                       workers=args.workers, ckpt_dir=args.ckpt,
                       sweeps=args.sweeps, device=args.device)
        save_corpus(rows, args.corpus)
        print(f"[costmodel] harvested {len(rows)} rows -> {args.corpus} "
              f"(digest {corpus_digest(rows)})")

    if args.fit:
        from .serial import save_model

        rows = load_corpus(args.corpus)
        model = fit(rows)
        save_model(model, args.out)
        print(f"[costmodel] fit {len(model.trees)} trees on {len(rows)} "
              f"rows -> {args.out} (digest {model_digest(model)})")

    if args.eval:
        from .serial import load_model

        rows = load_corpus(args.corpus)
        model, _ = load_model(args.model)
        m = evaluate(model, rows)
        print(f"[costmodel] eval on {m['n_rows']} rows / {m['n_groups']} "
              f"cells: agreement={m['agreement']:.3f} "
              f"mae_log2={m['mae_log2']:.4f} r2={m['r2']:.4f}")
        for kind, rate in m["by_kind"].items():
            print(f"[costmodel]   {kind}: agreement={rate:.3f}")

    if args.check:
        from .serial import load_model

        rows = load_corpus(args.corpus)
        refit = fit(rows)
        shipped, _ = load_model(DEFAULT_MODEL_DIR)
        ok = model_bytes(refit) == model_bytes(shipped)
        print(f"[costmodel] refit digest {model_digest(refit)} vs shipped "
              f"{model_digest(shipped)}: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            return 1
        m = evaluate(shipped, rows)
        print(f"[costmodel] shipped-model agreement on checked-in corpus: "
              f"{m['agreement']:.3f} over {m['n_groups']} cells")
        if m["agreement"] < 0.9:
            print("[costmodel] agreement below the 0.9 floor")
            return 1
    return 0


# package-level alias: `plan.fit_cost_model` (a bare `plan.fit` would
# read ambiguously next to `plan.compile`)
fit_cost_model = fit

__all__ = [
    "FEATURE_NAMES", "DEFAULT_CONFIG", "CostModel", "LabelPoint",
    "fit_cost_model",
    "LABEL_KINDS", "LABEL_SPECS", "features_for", "fit", "evaluate",
    "pick_winner", "model_bytes", "model_digest", "label_matrix",
    "label_cells", "run_label_cell", "harvest", "sort_rows",
    "save_corpus", "load_corpus", "corpus_digest", "default_model",
    "set_default_model", "DEFAULT_MODEL_DIR", "DEFAULT_CORPUS", "main",
]

if __name__ == "__main__":
    raise SystemExit(main())
