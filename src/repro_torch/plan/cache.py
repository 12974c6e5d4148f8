"""`PlanCache` -- compiled plans keyed by matrix content and options.

Counterpart of `repro.plan.cache`: keys are the matrix fingerprint
salted with the compile options, in the reference's format, so for the
option dict the graph drivers use (`graph.drivers.plan_options`) the
two packages produce the same key string, and so they do for a
`reorder=` given as a strategy name or as a concrete `Reordering`
(rendered `Reordering:{strategy}:{digest of row_perm, col_perm}`).  A
callable option's token carries its module path, so a strategy callable
of the port (`repro_torch.reorder...`) cannot key as the reference's
(`repro.reorder...`) does.  A `device` option, when given, is part of
the key like any other.

The streaming plan lifecycle (`plan.overlay`, `serve_graph`) uses
`peek`, `chained_key`, `install_overlay`, `swap` and
`note_delta_recompile`, counted in `overlays`, `swaps` and
`delta_recompiles`.  Compiles are also split by the scoring they ran
(`compile_stats["scoring"]`): 'model' into `predictor_compiles` /
`predictor_compile_s`, 'replay' and 'analytic' into `oracle_compiles` /
`oracle_compile_s`.  A sharded plan's `mesh` keys as the reference's
token `mesh:{shape}:{device ids}` with the torch devices' indices (a
CPU device as 0), its `partition` as `part:{digest of starts}`.
"""
from __future__ import annotations

import functools
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict

import numpy as np

from .fingerprint import (fingerprint_arrays, forget_fingerprint,
                          matrix_fingerprint)


def _fn_token(v) -> str:
    """Distinguish callables beyond module+name (two lambdas over
    different constants must not share a plan)."""
    code = getattr(v, "__code__", None)
    if code is not None:
        h = hashlib.blake2b(digest_size=8)
        h.update(code.co_code)
        h.update(repr(code.co_consts).encode())
        for cell in (getattr(v, "__closure__", None) or ()):
            h.update(_opt_token(cell.cell_contents).encode())
        h.update(repr(getattr(v, "__defaults__", None)).encode())
        return (f"fn:{getattr(v, '__module__', '?')}."
                f"{getattr(v, '__qualname__', '?')}:{h.hexdigest()}")
    if isinstance(v, functools.partial):
        kw = sorted((v.keywords or {}).items())
        return f"partial:{_fn_token(v.func)}:{v.args!r}:{kw!r}"
    return f"callable:{type(v).__module__}.{type(v).__qualname__}:{v!r}"


def _opt_token(v) -> str:
    """Stable string for one compile option."""
    from repro_torch.reorder import Reordering

    if isinstance(v, Reordering):
        return f"Reordering:{v.strategy}:" + fingerprint_arrays(
            np.asarray(v.row_perm), np.asarray(v.col_perm))
    if callable(v):
        return _fn_token(v)
    if isinstance(v, np.ndarray):
        return "nd:" + fingerprint_arrays(v)
    from repro_torch.distributed.spmv import RowMesh

    if isinstance(v, RowMesh):                     # "cuda:0" keys apart from "cpu"
        return f"mesh:{v.shape}:{[str(d) for d in v.devices]}"
    if hasattr(v, "starts"):                               # a RowPartition
        return "part:" + fingerprint_arrays(np.asarray(v.starts))
    return repr(v)


def compile_kwargs(opts: Dict) -> Dict:
    """A keyed option dict as `compile` takes it: the reference's
    `interpret=None` (which `graph.drivers.plan_options` gives, so that
    keys stay the reference's) is dropped."""
    return {k: v for k, v in opts.items()
            if not (k == "interpret" and v is None)}


class PlanCache:
    """LRU cache of compiled `SpmvPlan`s keyed by matrix content +
    options."""

    def __init__(self, max_plans: int = 32):
        self.max_plans = max_plans
        self._plans: "OrderedDict[str, object]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compiles = 0
        self.compile_s = 0.0
        # compiles by scoring: learned model vs simulation oracle
        self.predictor_compiles = 0
        self.predictor_compile_s = 0.0
        self.oracle_compiles = 0
        self.oracle_compile_s = 0.0
        # streaming lifecycle: overlaid plans installed, atomic base
        # swaps landed, re-plans forced by a past-budget (or
        # overlay-ineligible) delta
        self.overlays = 0
        self.swaps = 0
        self.delta_recompiles = 0

    def __len__(self) -> int:
        return len(self._plans)

    @staticmethod
    def key_for(matrix, **opts) -> str:
        salt = ";".join(f"{k}={_opt_token(v)}"
                        for k, v in sorted(opts.items()))
        return f"{matrix_fingerprint(matrix)}|{salt}"

    def contains(self, key: str) -> bool:
        """Probe: no LRU promotion, no hit/miss accounting."""
        with self._lock:
            return key in self._plans

    def peek(self, key: str):
        """The resident value for `key`, or None; a probe like
        `contains`."""
        with self._lock:
            return self._plans.get(key)

    @staticmethod
    def chained_key(old_key: str, fingerprint: str) -> str:
        """Re-key an entry under a new (chained) fingerprint, keeping the
        option salt: no matrix re-hash."""
        _, salt = old_key.split("|", 1)
        return f"{fingerprint}|{salt}"

    def install_overlay(self, key: str, overlaid, supersedes: str | None = None
                        ) -> None:
        """Insert an `OverlaidPlan` under its chained key and drop the
        superseded generation in the same critical section, so no probe
        ever sees both generations warm."""
        with self._lock:
            self._plans[key] = overlaid
            self._plans.move_to_end(key)
            self.overlays += 1
            if supersedes is not None and supersedes != key:
                self._plans.pop(supersedes, None)
            while len(self._plans) > self.max_plans:
                self._plans.popitem(last=False)
                self.evictions += 1

    def swap(self, key: str, builder: Callable[[], object],
             supersedes: str | None = None):
        """Atomic re-plan landing: build (or reuse) the plan for `key`
        and retire the superseded generation; after `swap` returns,
        probes see exactly one generation."""
        value = self.get_or_build(key, builder)
        with self._lock:
            if supersedes is not None and supersedes != key:
                self._plans.pop(supersedes, None)
            self.swaps += 1
        return value

    def note_delta_recompile(self) -> None:
        """Count one delta-forced re-plan, when it is scheduled."""
        with self._lock:
            self.delta_recompiles += 1

    def get_or_build(self, key: str, builder: Callable[[], object]):
        """The cached value for `key`, or build, insert (evicting the
        least recently used past `max_plans`) and return it."""
        with self._lock:
            if key in self._plans:
                self._plans.move_to_end(key)
                self.hits += 1
                return self._plans[key]
        t0 = time.perf_counter()
        value = builder()          # build outside the lock (can be slow)
        elapsed = time.perf_counter() - t0
        with self._lock:
            if key not in self._plans:
                self.misses += 1
                self.compiles += 1
                self.compile_s += elapsed
                scoring = (getattr(value, "compile_stats", None)
                           or {}).get("scoring")
                if scoring == "model":
                    self.predictor_compiles += 1
                    self.predictor_compile_s += elapsed
                elif scoring in ("replay", "analytic"):
                    self.oracle_compiles += 1
                    self.oracle_compile_s += elapsed
                self._plans[key] = value
                while len(self._plans) > self.max_plans:
                    self._plans.popitem(last=False)
                    self.evictions += 1
            else:
                self.hits += 1
            self._plans.move_to_end(key)
            return self._plans[key]

    def get_or_compile(self, matrix, **opts):
        """`compile`d plan for (matrix contents, opts), cached; the same
        signature as `repro_torch.plan.compile`, which also takes the
        reference's `interpret=None` (as `graph.drivers.plan_options`
        gives it): keyed, so the key is the reference's, and dropped."""
        from .compiler import compile as _compile

        key = self.key_for(matrix, **opts)
        return self.get_or_build(
            key, lambda: _compile(matrix, **compile_kwargs(opts)))

    def invalidate(self, matrix_or_fingerprint) -> int:
        """Drop every plan for a matrix (any options): given a
        fingerprint string or the container itself, whose memoised digest
        is forgotten first so plans under the stale digest and under the
        re-hash of its current bytes both go.  Returns the count."""
        if isinstance(matrix_or_fingerprint, str):
            fps = {matrix_or_fingerprint}
        else:
            stale_fp = forget_fingerprint(matrix_or_fingerprint)
            fps = {matrix_fingerprint(matrix_or_fingerprint)}
            if stale_fp is not None:
                fps.add(stale_fp)
        with self._lock:
            stale = [k for k in self._plans if k.split("|", 1)[0] in fps]
            for k in stale:
                del self._plans[k]
            return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self.hits = self.misses = self.evictions = self.compiles = 0
            self.compile_s = 0.0
            self.predictor_compiles = self.oracle_compiles = 0
            self.predictor_compile_s = self.oracle_compile_s = 0.0
            self.overlays = self.swaps = self.delta_recompiles = 0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            served = self.hits + self.misses
            return {"plans": len(self._plans), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "compiles": self.compiles,
                    "compile_s": round(self.compile_s, 6),
                    "predictor_compiles": self.predictor_compiles,
                    "predictor_compile_s": round(self.predictor_compile_s, 6),
                    "oracle_compiles": self.oracle_compiles,
                    "oracle_compile_s": round(self.oracle_compile_s, 6),
                    "overlays": self.overlays, "swaps": self.swaps,
                    "delta_recompiles": self.delta_recompiles,
                    "hit_rate": self.hits / served if served else 0.0}


DEFAULT_CACHE = PlanCache()


def get_plan(matrix, **opts):
    """`compile` through the process-wide `DEFAULT_CACHE`."""
    return DEFAULT_CACHE.get_or_compile(matrix, **opts)


__all__ = ["PlanCache", "DEFAULT_CACHE", "get_plan", "compile_kwargs"]
