"""Content fingerprints of sparse-matrix containers.

Counterpart of `repro.plan.fingerprint`: a blake2b digest over the type
name and each array's shape, dtype string and raw bytes, in the
container's declaration order -- the same bytes in the same order as the
reference hashes its pytree leaves, so the two packages give the same
digest (and the same plan-cache key) for the same matrix.  Device
tensors are copied to the host to be hashed; the digest is memoised per
container object, with a weakref evicting it when the object dies.
"""
from __future__ import annotations

import hashlib
import weakref

import numpy as np

from repro_torch.core.formats import array_fields
from repro_torch.device import to_numpy

_FP_MEMO: dict = {}
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


def matrix_fingerprint(matrix) -> str:
    """Digest of a container (CSR/ELL/BELL/DIA/HYB); the type name takes
    part, so a CSR and the DIA converted from it differ.  O(1) after the
    first call on an object."""
    key = id(matrix)
    entry = _FP_MEMO.get(key)
    if entry is not None and entry[0]() is matrix:
        return entry[1]
    fp = fingerprint_arrays(*array_fields(matrix),
                            extra=type(matrix).__name__)
    try:
        ref = weakref.ref(matrix, lambda _, k=key: _FP_MEMO.pop(k, None))
    except TypeError:
        return fp                      # not weakref-able: no memo
    _FP_MEMO[key] = (ref, fp)
    while len(_FP_MEMO) > _MEMO_CAP:
        _FP_MEMO.pop(next(iter(_FP_MEMO)))
    return fp


__all__ = ["fingerprint_arrays", "matrix_fingerprint"]
