"""Semirings: the (⊕, ⊗) pairs that turn SpMV into graph analytics.

Counterpart of `repro.graph.semiring`:

    plus_times   y[i] = Σ_j   A[i,j] * x[j]     PageRank
    min_plus     y[i] = min_j A[i,j] + x[j]     SSSP, connected components
    or_and       y[i] = OR_j  A[i,j] & x[j]     BFS ({0,1} indicators; OR=max)
    max_times    y[i] = max_j A[i,j] * x[j]     widest path (nonnegative)

Padding contract: a padding slot holds `pad_value`, which is absorbing
(`mul(pad_value, x) == identity`), so padded slots vanish under ⊕.
DIA is plus-times only because it stores absent entries as 0.0.

`code` selects the CUDA kernels' template instantiation; the four
kernels that take a semiring switch on it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Union

import torch


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A (⊕, ⊗) pair with the identities the kernels and layouts need.

    add / mul   elementwise torch binary ops (⊕ / ⊗)
    scatter     the `scatter_reduce` mode matching `add`
    identity    ⊕-identity: the value of an empty reduction
    pad_value   stored-slot fill: mul(pad_value, x) == identity
    code        the CUDA kernels' semiring selector
    """

    name: str
    add: Callable
    mul: Callable
    scatter: str
    identity: float
    pad_value: float
    code: int

    def __repr__(self) -> str:          # stable across runs: cache-key safe
        return f"Semiring({self.name})"

    def reduce(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """⊕ over `dim` (which must be non-empty)."""
        if self.scatter == "sum":
            return t.sum(dim=dim)
        if self.scatter == "amin":
            return t.amin(dim=dim)
        return t.amax(dim=dim)

    def full(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.full(shape, self.identity, dtype=like.dtype,
                          device=like.device)

    def segment(self, src: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
        """⊕ of `src[..., j]` into segment `index[j]` along the last axis.

        The output starts at the ⊕-identity and `include_self=False`
        leaves segments that receive nothing untouched, so an empty
        segment reads the identity -- the value the reference restores
        with its `where(nonempty, ...)` (torch's own defaults would fold
        the starting value into every segment instead)."""
        out = self.full(src.shape[:-1] + (num_segments,), src)
        idx = index.to(torch.int64).expand(src.shape)
        return out.scatter_reduce(-1, idx, src, reduce=self.scatter,
                                  include_self=False)


PLUS_TIMES = Semiring("plus_times", torch.add, torch.mul, "sum", 0.0, 0.0, 0)
MIN_PLUS = Semiring("min_plus", torch.minimum, torch.add, "amin",
                    math.inf, math.inf, 1)
OR_AND = Semiring("or_and", torch.maximum, torch.mul, "amax", 0.0, 0.0, 2)
MAX_TIMES = Semiring("max_times", torch.maximum, torch.mul, "amax",
                     0.0, 0.0, 3)

SEMIRINGS = {s.name: s for s in (PLUS_TIMES, MIN_PLUS, OR_AND, MAX_TIMES)}


def resolve(semiring: Union[str, Semiring, None]) -> Semiring:
    """Name | instance | None (-> plus_times) to a registry `Semiring`."""
    if semiring is None:
        return PLUS_TIMES
    if isinstance(semiring, Semiring):
        return semiring
    return SEMIRINGS[semiring]


__all__ = ["Semiring", "PLUS_TIMES", "MIN_PLUS", "OR_AND", "MAX_TIMES",
           "SEMIRINGS", "resolve"]
