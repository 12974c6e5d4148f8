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
the key like any other.  The overlay, swap and delta-recompile counters
wait for the streaming slice (ROADMAP A6), the mesh / partition tokens
for theirs.
"""
from __future__ import annotations

import functools
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict

import numpy as np

from .fingerprint import fingerprint_arrays, matrix_fingerprint


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
    return repr(v)


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
        if "interpret" in opts and opts["interpret"] is None:
            del opts["interpret"]
        return self.get_or_build(key, lambda: _compile(matrix, **opts))

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self.hits = self.misses = self.evictions = self.compiles = 0
            self.compile_s = 0.0

    def stats(self) -> Dict[str, float]:
        with self._lock:
            served = self.hits + self.misses
            return {"plans": len(self._plans), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions,
                    "compiles": self.compiles,
                    "compile_s": round(self.compile_s, 6),
                    "hit_rate": self.hits / served if served else 0.0}


DEFAULT_CACHE = PlanCache()


def get_plan(matrix, **opts):
    """`compile` through the process-wide `DEFAULT_CACHE`."""
    return DEFAULT_CACHE.get_or_compile(matrix, **opts)


__all__ = ["PlanCache", "DEFAULT_CACHE", "get_plan"]
