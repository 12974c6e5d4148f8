"""The result type every reordering strategy produces.

Counterpart of `repro.reorder.types`.  A `Reordering` is a pair of host
numpy int64 permutations plus provenance, with the reference's
convention

    A'[i, j] = A[row_perm[i], col_perm[j]]

so SpMV transports as

    x' = x[col_perm]          (permute_x)
    y' = A' @ x'
    y  = y'[inv_row_perm]     (restore_y)

`permute_x` / `restore_y` take tensors and gather with `index_select`;
the index tensors are uploaded to a device once per reordering and kept
on it, so a plan that carries the reordering pays one gather per call
and no upload.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


def invert_permutation(perm: np.ndarray) -> np.ndarray:
    """inv[perm[i]] = i, O(n) (argsort-free)."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=np.int64)
    return inv


def is_permutation(perm: np.ndarray, n: int) -> bool:
    perm = np.asarray(perm)
    return perm.shape == (n,) and np.array_equal(np.sort(perm), np.arange(n))


@dataclasses.dataclass(frozen=True)
class Reordering:
    """Row/column permutation pair with provenance: `strategy` names the
    producing strategy ("rcm", "degree-sort", ... or "chain(a,b)"),
    `params` its knobs, `stats` what it measured while running."""

    row_perm: np.ndarray            # new row i holds old row row_perm[i]
    col_perm: np.ndarray            # new col j holds old col col_perm[j]
    strategy: str = "identity"
    params: Dict = dataclasses.field(default_factory=dict)
    stats: Dict = dataclasses.field(default_factory=dict)
    # (name, device) -> int64 index tensor, filled on first use
    _index: Dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.row_perm.size, self.col_perm.size)

    @property
    def inv_row_perm(self) -> np.ndarray:
        return invert_permutation(self.row_perm)

    @property
    def inv_col_perm(self) -> np.ndarray:
        return invert_permutation(self.col_perm)

    def validate(self) -> None:
        n_r, n_c = self.shape
        if not is_permutation(self.row_perm, n_r):
            raise ValueError(f"{self.strategy}: row_perm is not a permutation")
        if not is_permutation(self.col_perm, n_c):
            raise ValueError(f"{self.strategy}: col_perm is not a permutation")

    # -- application --------------------------------------------------------

    def apply(self, csr):
        """A' with A'[i, j] = A[row_perm[i], col_perm[j]], on the CSR's
        device."""
        return csr.permute(self.row_perm, self.col_perm)

    def index(self, name: str, device) -> torch.Tensor:
        """`col_perm` or `inv_row_perm` as an int64 tensor on `device`,
        uploaded once."""
        key = (name, torch.device(device))
        t = self._index.get(key)
        if t is None:
            perm = {"col_perm": lambda: self.col_perm,
                    "inv_row_perm": lambda: self.inv_row_perm}[name]()
            t = torch.from_numpy(np.ascontiguousarray(perm, dtype=np.int64)
                                 ).to(key[1])
            self._index[key] = t
        return t

    def permute_x(self, x: torch.Tensor) -> torch.Tensor:
        """x' for the reordered multiply: x'[j] = x[col_perm[j]] along
        the last axis (x may be a (k, n) batch)."""
        x = torch.as_tensor(x)
        return x.index_select(x.dim() - 1, self.index("col_perm", x.device))

    def restore_y(self, y_perm: torch.Tensor) -> torch.Tensor:
        """y' back in the original row order: y = y'[inv_row_perm] along
        the last axis."""
        y_perm = torch.as_tensor(y_perm)
        return y_perm.index_select(y_perm.dim() - 1,
                                   self.index("inv_row_perm", y_perm.device))

    # -- composition --------------------------------------------------------

    def then(self, other: "Reordering") -> "Reordering":
        """The reordering equivalent to applying self, then `other`."""
        return Reordering(
            row_perm=np.asarray(self.row_perm)[np.asarray(other.row_perm)],
            col_perm=np.asarray(self.col_perm)[np.asarray(other.col_perm)],
            strategy=f"{self.strategy}+{other.strategy}",
            params={**self.params, **other.params},
            stats={**self.stats, **other.stats},
        )

    def summary(self) -> str:
        extra = " ".join(f"{k}={v}" for k, v in sorted(self.stats.items()))
        return f"{self.strategy}: rows={self.shape[0]} cols={self.shape[1]}" \
               + (f" [{extra}]" if extra else "")


def identity_reordering(n_rows: int, n_cols: int | None = None) -> Reordering:
    n_cols = n_rows if n_cols is None else n_cols
    return Reordering(row_perm=np.arange(n_rows, dtype=np.int64),
                      col_perm=np.arange(n_cols, dtype=np.int64),
                      strategy="identity")


__all__ = ["Reordering", "identity_reordering", "invert_permutation",
           "is_permutation"]
