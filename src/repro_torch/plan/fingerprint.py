"""Content fingerprints of sparse-matrix containers.

Counterpart of `repro.plan.fingerprint`: a blake2b digest over the type
name and each array's shape, dtype string and raw bytes, in the
container's declaration order -- the same bytes in the same order as the
reference hashes its pytree leaves, so the two packages give the same
digest (and the same plan-cache key) for the same matrix.  Device
tensors are copied to the host to be hashed; the digest is memoised per
container object, with a weakref evicting it when the object dies.

The streaming lifecycle adds `delta_fingerprint` (an `EdgeDelta`'s
digest, memoised per delta under the same discipline) and
`chain_fingerprint`, which derives the digest of base + delta from the
two digests alone, so no overlay generation re-hashes the base matrix;
`forget_fingerprint` drops a container's memoised digest after an
in-place mutation.  All digests equal the reference's.
"""
from __future__ import annotations

import hashlib
import weakref

import numpy as np

from repro_torch.core.formats import array_fields
from repro_torch.device import to_numpy

_FP_MEMO: dict = {}
_DELTA_MEMO: dict = {}       # same discipline, for EdgeDelta digests
_MEMO_CAP = 4096


def fingerprint_arrays(*arrays, extra: str = "") -> str:
    """blake2b digest over array shapes, dtypes and raw bytes."""
    h = hashlib.blake2b(digest_size=16)
    h.update(extra.encode())
    for a in arrays:
        a = to_numpy(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _memo_get(memo: dict, obj):
    entry = memo.get(id(obj))
    if entry is not None and entry[0]() is obj:
        return entry[1]
    return None


def _memo_put(memo: dict, obj, fp: str) -> None:
    """Memoise `fp` for `obj`, evicted by a weakref when `obj` dies (so a
    recycled id never serves a stale digest); past `_MEMO_CAP` the
    oldest entries go first."""
    key = id(obj)
    try:
        ref = weakref.ref(obj, lambda _, k=key, m=memo: m.pop(k, None))
    except TypeError:
        return                          # not weakref-able: no memo
    memo[key] = (ref, fp)
    while len(memo) > _MEMO_CAP:
        memo.pop(next(iter(memo)))


def forget_fingerprint(matrix) -> str | None:
    """Drop `matrix`'s memoised digest, returning it if one was memoised
    for this exact object (`PlanCache.invalidate` uses it after an
    in-place mutation, which the per-object memo cannot see)."""
    entry = _FP_MEMO.pop(id(matrix), None)
    if entry is not None and entry[0]() is matrix:
        return entry[1]
    return None


def matrix_fingerprint(matrix) -> str:
    """Digest of a container (CSR/ELL/BELL/DIA/HYB); the type name takes
    part, so a CSR and the DIA converted from it differ.  O(1) after the
    first call on an object."""
    fp = _memo_get(_FP_MEMO, matrix)
    if fp is None:
        fp = fingerprint_arrays(*array_fields(matrix),
                                extra=type(matrix).__name__)
        _memo_put(_FP_MEMO, matrix, fp)
    return fp


def delta_fingerprint(delta) -> str:
    """Digest of an `EdgeDelta` (coordinates, values, delete flags,
    shape), memoised per delta object: a delta hashes once however many
    overlay generations carry it."""
    fp = _memo_get(_DELTA_MEMO, delta)
    if fp is None:
        fp = fingerprint_arrays(
            delta.rows, delta.cols, delta.vals, delta.deletes,
            extra=f"EdgeDelta:{delta.n_rows}x{delta.n_cols}")
        _memo_put(_DELTA_MEMO, delta, fp)
    return fp


def chain_fingerprint(base_fp: str, delta_fp: str) -> str:
    """Digest of base + delta from the two digests alone: the base is
    never re-hashed when a delta arrives, and chains compose.  Two batch
    histories reaching the same net matrix get different digests (both
    still name correct plans)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(b"chain:")
    h.update(base_fp.encode())
    h.update(b"+")
    h.update(delta_fp.encode())
    return h.hexdigest()


__all__ = ["fingerprint_arrays", "matrix_fingerprint", "delta_fingerprint",
           "chain_fingerprint", "forget_fingerprint"]
