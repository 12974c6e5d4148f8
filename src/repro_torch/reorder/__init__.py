"""Permutations that turn unstructured matrices FD-like (counterpart of
`repro.reorder`): reorder, re-decide the format, multiply in the
original order.

    from repro_torch import reorder
    r = reorder.rcm(csr)              # Reordering (host numpy perms)
    a2 = r.apply(csr)                 # permuted CSR, on csr's device
    fmt = auto_format(csr, reordering=r)
    y = spmv(fmt, x, reordering=r)    # y in the ORIGINAL row order
"""
from .strategies import (STRATEGIES, Strategy, cache_block, chain,
                         degree_sort, identity, rcm)
from .types import (Reordering, identity_reordering, invert_permutation,
                    is_permutation)

__all__ = [
    "Reordering", "Strategy", "STRATEGIES", "identity_reordering",
    "invert_permutation", "is_permutation", "rcm", "degree_sort",
    "cache_block", "chain", "identity",
]
