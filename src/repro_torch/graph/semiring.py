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
import weakref
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
        """⊕ over `dim` (which must be non-empty); sums by `tree_sum`, so
        a batch row sums as the same vector alone."""
        if self.scatter == "sum":
            return tree_sum(t, dim)
        if self.scatter == "amin":
            return t.amin(dim=dim)
        return t.amax(dim=dim)

    def full(self, shape, like: torch.Tensor) -> torch.Tensor:
        return torch.full(shape, self.identity, dtype=like.dtype,
                          device=like.device)

    def segment(self, src: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
        """⊕ of `src[..., j]` into segment `index[j]` along the last axis;
        a segment that receives nothing reads the ⊕-identity (the value
        the reference restores with its `where(nonempty, ...)`).

        Sums go through `ordered_sum`, whose order is fixed by the
        index alone, so replays are bit-identical on the card too (CUDA's
        `scatter_reduce(sum)` adds with atomics, in an order that changes
        between runs).  min and max are order-free and keep
        `scatter_reduce`, with `include_self=False` so the identity is
        not folded into every segment."""
        if self.scatter == "sum":
            return ordered_sum(src, index, num_segments)
        out = self.full(src.shape[:-1] + (num_segments,), src)
        idx = index.to(torch.int64).expand(src.shape)
        return out.scatter_reduce(-1, idx, src, reduce=self.scatter,
                                  include_self=False)


def ordered_sum(src: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Σ of `src[..., j]` into segment `index[j]` along the last axis, in
    an order that depends on the index only: a stable sort by segment,
    then each segment's run, padded with +0 to the next power of two, is
    halved pairwise (run[:h] + run[h:2h]) down to one value.  Only
    elementwise adds, so a row of a (k, n) batch sums exactly as the
    same vector alone.  The runs come from `segment_runs`, worked out
    once per index tensor, so a call only gathers and halves.  Empty
    segments read +0."""
    out = torch.zeros(src.shape[:-1] + (num_segments,), dtype=src.dtype,
                      device=src.device)
    padded = torch.nn.functional.pad(src, (0, 1))       # slot -1 holds +0
    for rows, gather in segment_runs(index, num_segments):
        out[..., rows] = tree_sum(padded[..., gather], -1)
    return out


def segment_runs(index: torch.Tensor, num_segments: int):
    """The run table of `ordered_sum`: per padded width w, the segments
    whose run pads to w and a (segments, w) gather of their entries in
    stable-sorted order, padding slots pointing past the last entry.
    Runs are grouped by width, so the padding costs at most twice the
    entries.  Built once per index tensor (`cached_on`)."""
    return cached_on(index, ("segment_runs", num_segments),
                     lambda: _segment_runs(index, num_segments))


def _segment_runs(index, num_segments):
    n = index.numel()
    idx, perm = torch.sort(index.to(torch.int64), stable=True)
    segs = torch.arange(num_segments, device=index.device)
    start = torch.searchsorted(idx, segs)
    length = torch.searchsorted(idx, segs, right=True) - start
    filled = length > 0
    width = (2 ** torch.ceil(torch.log2(length.clamp(min=1).double()))).long()
    perm = torch.cat([perm, perm.new_full((1,), n)])    # n: the +0 slot
    runs = []
    for w in torch.unique(width[filled]).tolist():
        rows = torch.nonzero(filled & (width == w)).flatten()
        pos = start[rows, None] + torch.arange(w, device=index.device)
        real = pos < (start + length)[rows, None]
        runs.append((rows, perm[torch.where(real, pos, n)]))
    return runs


#: id(tensor) -> (weak reference, (tag, version), value) for `cached_on`
_CACHE: dict = {}


def cached_on(t: torch.Tensor, tag, build: Callable):
    """`build()`, computed once for tensor `t` and `tag` and kept while
    `t` lives and is not modified in place (its version counter moves).
    The value must not hold `t` itself."""
    key = id(t)
    hit = _CACHE.get((key, tag))
    if hit is not None and hit[0]() is t and hit[1] == t._version:
        return hit[2]
    value = build()
    ref = weakref.ref(t, lambda _, k=(key, tag): _CACHE.pop(k, None))
    _CACHE[(key, tag)] = (ref, t._version, value)
    return value


def tree_sum(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Σ over `dim`, padded with +0 to a power of two and halved pairwise
    (t[:h] + t[h:2h]) down to one value: a fixed order of elementwise
    adds, the same on every device and for every batch shape."""
    t = t.movedim(dim, -1)
    w = t.shape[-1]
    if w & (w - 1):
        t = torch.nn.functional.pad(t, (0, (1 << (w - 1).bit_length()) - w))
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


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


__all__ = ["Semiring", "ordered_sum", "segment_runs", "cached_on",
           "tree_sum", "PLUS_TIMES", "MIN_PLUS",
           "OR_AND", "MAX_TIMES", "SEMIRINGS", "resolve"]
