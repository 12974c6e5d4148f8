"""Batched edge deltas: the mutation container for streaming matrices.

Counterpart of `repro.core.delta`.  An `EdgeDelta` is a batch of edge
inserts and deletes against one *base* CSR, small enough to serve as a
COO correction pass after the planned SpMV (`repro_torch.plan.overlay`)
and to materialise when the plan must be rebuilt (`CSR.apply_delta`).

Overlay algebra: under plus_times SpMV is linear, (A + Δ)x = Ax + Δx,
so an insert is a COO entry with its value and a delete the same entry
negated.  The other semirings have no ⊕-inverse: an insert still
overlays (y' = y ⊕ (Δ ⊗ x)), a delete cannot be undone after the base
reduction, so a delta with deletes is overlay-ineligible there.

Contract: coordinates are unique per operation (an insert names an
absent coordinate, a delete a present one; "change a value" is a delete
plus an insert of the same coordinate in one batch, deletes first).
Base CSRs must be canonical -- (row, col)-sorted and duplicate-free --
and others are refused, as the reference refuses them (ROADMAP C1: the
reference's `fd_matrix` emits duplicates for some sizes, n = 22 among
them, and the port reproduces both the duplicates and the refusal).

The delta itself is host numpy, byte for byte the reference's arrays.
A port CSR holds tensors, and the key work -- flattening coordinates to
row * n_cols + col, checking they ascend, matching them by binary
search -- runs where the CSR lies, so a CSR on the card matches its
tens of millions of keys there and only the delta's entries come back
to the host.  Keys and searches are integer work, so the results are
the reference's wherever they run.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np
import torch

from repro_torch.device import to_numpy

from .formats import CSR


def _keys(csr: CSR, who: str) -> torch.Tensor:
    """Flattened (row * n_cols + col) int64 keys of a canonical CSR, on
    its device, strictly ascending.  Raises on unsorted or duplicate
    coordinates."""
    dev = csr.indptr.device
    rows = torch.repeat_interleave(
        torch.arange(csr.n_rows, device=dev),
        torch.diff(csr.indptr.to(torch.int64)), output_size=csr.nnz)
    keys = rows * csr.n_cols + csr.indices.to(torch.int64)
    if keys.numel() > 1 and not bool((keys[1:] > keys[:-1]).all()):
        raise ValueError(
            f"{who} requires a canonically (row, col)-sorted, duplicate-free "
            "CSR (build via CSR.from_coo with unique coordinates)")
    return keys


def _member(query_keys: torch.Tensor, base_keys: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found mask, position) of each query key in sorted `base_keys`,
    both tensors on one device."""
    if base_keys.numel() == 0:
        z = torch.zeros_like(query_keys)
        return z.to(torch.bool), z
    pos = torch.searchsorted(base_keys, query_keys)
    pos_c = pos.clamp(max=base_keys.numel() - 1)
    return (pos < base_keys.numel()) & (base_keys[pos_c] == query_keys), \
        pos_c


def _query(keys: torch.Tensor, rows, cols, n_cols: int) -> torch.Tensor:
    return torch.from_numpy(np.asarray(rows, np.int64) * n_cols
                            + np.asarray(cols, np.int64)).to(keys.device)


def csr_lookup(csr: CSR, rows, cols) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorised coordinate lookup: (values, found mask) for each
    (rows[i], cols[i]) in a canonical CSR.  Absent coordinates report
    value 0.0 and found=False."""
    keys = _keys(csr, "csr_lookup")
    found, pos = _member(_query(keys, rows, cols, csr.n_cols), keys)
    data = csr.data
    vals = torch.where(found, data[pos], torch.zeros((), dtype=data.dtype,
                                                     device=data.device)) \
        if data.numel() else torch.zeros(found.shape, dtype=torch.float32)
    return to_numpy(vals), to_numpy(found)


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """A canonical batch of edge mutations against one base matrix.

    Entries are (row, col, value, is_delete), sorted by (row, col) with
    a coordinate's delete before its re-insert; at most one delete and
    one insert may name a coordinate.  Delete values record the base
    value being removed (what the plus_times overlay negates).  Build
    through `from_updates` / `csr_diff` / `merge`.
    """

    rows: np.ndarray       # (nnz,) int64
    cols: np.ndarray       # (nnz,) int64
    vals: np.ndarray       # (nnz,) float32; for deletes, the removed value
    deletes: np.ndarray    # (nnz,) bool
    n_rows: int
    n_cols: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def nnz(self) -> int:
        return int(self.rows.size)

    @property
    def n_deletes(self) -> int:
        return int(self.deletes.sum())

    @property
    def n_inserts(self) -> int:
        return self.nnz - self.n_deletes

    @property
    def has_deletes(self) -> bool:
        return bool(self.deletes.any())

    @staticmethod
    def _build(rows, cols, vals, deletes, n_rows: int, n_cols: int
               ) -> "EdgeDelta":
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        vals = np.asarray(vals, dtype=np.float32).ravel()
        deletes = np.asarray(deletes, dtype=bool).ravel()
        if not (rows.shape == cols.shape == vals.shape == deletes.shape):
            raise ValueError("rows/cols/vals/deletes must be equal-length")
        if rows.size:
            if (rows.min() < 0 or rows.max() >= n_rows
                    or cols.min() < 0 or cols.max() >= n_cols):
                raise ValueError(
                    f"delta coordinates out of range for {n_rows}x{n_cols}")
            order = np.lexsort((~deletes, cols, rows))
            rows, cols = rows[order], cols[order]
            vals, deletes = vals[order], deletes[order]
            keys = rows * n_cols + cols
            same = keys[1:] == keys[:-1]
            pair_ok = deletes[:-1] & ~deletes[1:]       # delete then insert
            if (same & ~pair_ok).any() or (same[1:] & same[:-1]).any():
                raise ValueError(
                    "a coordinate may carry at most one delete and one "
                    "insert per delta batch")
        return EdgeDelta(rows=rows, cols=cols, vals=vals, deletes=deletes,
                         n_rows=int(n_rows), n_cols=int(n_cols))

    @staticmethod
    def empty(n_rows: int, n_cols: int) -> "EdgeDelta":
        z = np.zeros(0, dtype=np.int64)
        return EdgeDelta(rows=z, cols=z.copy(),
                         vals=np.zeros(0, dtype=np.float32),
                         deletes=np.zeros(0, dtype=bool),
                         n_rows=int(n_rows), n_cols=int(n_cols))

    @staticmethod
    def from_updates(base: CSR, inserts: Iterable = (),
                     deletes: Iterable = ()) -> "EdgeDelta":
        """Validated delta from user-level updates against `base`:
        `inserts` are (row, col, value) triples naming absent
        coordinates, `deletes` (row, col) pairs naming present ones (the
        removed value is looked up here).  Violations raise."""
        ins = np.asarray(list(inserts), dtype=np.float64).reshape(-1, 3)
        dels = np.asarray(list(deletes), dtype=np.int64).reshape(-1, 2)
        ir = ins[:, 0].astype(np.int64)
        ic = ins[:, 1].astype(np.int64)
        iv = ins[:, 2].astype(np.float32)
        dr, dc = dels[:, 0], dels[:, 1]
        dvals, found = csr_lookup(base, dr, dc)
        if not found.all():
            missing = [(int(r), int(c)) for r, c in
                       zip(dr[~found][:5], dc[~found][:5])]
            raise ValueError(f"deletes name absent coordinates: {missing}")
        _, present = csr_lookup(base, ir, ic)
        if present.any():
            del_keys = dr * base.n_cols + dc
            bad = present & ~np.isin(ir * base.n_cols + ic, del_keys)
            if bad.any():
                clash = [(int(r), int(c)) for r, c in
                         zip(ir[bad][:5], ic[bad][:5])]
                raise ValueError(
                    f"inserts target stored coordinates {clash}; delete "
                    "first (delete+insert in one batch updates the value)")
        return EdgeDelta._build(
            np.concatenate([dr, ir]), np.concatenate([dc, ic]),
            np.concatenate([dvals.astype(np.float32), iv]),
            np.concatenate([np.ones(dr.size, bool), np.zeros(ir.size, bool)]),
            base.n_rows, base.n_cols)

    def merge(self, other: "EdgeDelta") -> "EdgeDelta":
        """Net effect of `self` followed by `other` (`other` was built
        against `self` applied to the base).  Insert-then-delete of one
        coordinate annihilates; delete-then-reinsert folds to a value
        change.  The result is one delta against the original base.

        The reference folds entry by entry through a dict; here each
        coordinate's at most four events (self's delete and insert, then
        other's) are folded at once over the sorted union of keys, which
        gives the same final state per coordinate -- and `_build` sorts
        the result totally, so the arrays are the reference's -- and
        raises the reference's error for the first offending entry of
        `other`."""
        if self.shape != other.shape:
            raise ValueError(f"shape mismatch: {self.shape} vs {other.shape}")
        n_cols = self.n_cols
        s_keys = self.rows * n_cols + self.cols
        o_keys = other.rows * n_cols + other.cols
        keys = np.unique(np.concatenate([s_keys, o_keys]))

        def slot(k, v, mask):
            """(present, value) over `keys` of the entries under `mask`
            (each key at most once: one delete and one insert a key)."""
            at = np.searchsorted(keys, k[mask])
            present = np.zeros(keys.size, dtype=bool)
            value = np.zeros(keys.size, dtype=np.float32)
            present[at] = True
            value[at] = v[mask]
            return present, value

        sd, sdv = slot(s_keys, self.vals, self.deletes)
        si, siv = slot(s_keys, self.vals, ~self.deletes)
        od, odv = slot(o_keys, other.vals, other.deletes)
        oi, oiv = slot(o_keys, other.vals, ~other.deletes)
        del_twice = od & sd & ~si         # deleting a base edge again
        ins_twice = oi & si & ~od         # inserting over our own insert
        at = np.searchsorted(keys, o_keys)
        bad = np.where(other.deletes, del_twice[at], ins_twice[at])
        if bad.any():
            first = int(np.argmax(bad))
            r, c = other.rows[first], other.cols[first]
            if other.deletes[first]:
                raise ValueError(
                    f"coordinate ({r}, {c}) deleted twice without an "
                    "intervening insert")
            raise ValueError(
                f"coordinate ({r}, {c}) inserted twice without an "
                "intervening delete")
        has_dv = sd | (od & ~si)
        dv = np.where(sd, sdv, odv)
        has_iv = oi | (si & ~od)
        iv = np.where(oi, oiv, siv)
        dk, ik = keys[has_dv], keys[has_iv]
        return EdgeDelta._build(
            np.concatenate([dk // n_cols, ik // n_cols]),
            np.concatenate([dk % n_cols, ik % n_cols]),
            np.concatenate([dv[has_dv], iv[has_iv]]),
            np.concatenate([np.ones(dk.size, bool), np.zeros(ik.size, bool)]),
            self.n_rows, self.n_cols)

    def signed_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, values) with delete values negated -- the
        plus_times overlay stream: (A + Δ)x = Ax + Δx."""
        vals = np.where(self.deletes, -self.vals, self.vals)
        return self.rows, self.cols, vals.astype(np.float32)

    def insert_coo(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, values) of the inserts only -- the overlay stream
        for ⊕-only semirings.  Refuses a delta with deletes."""
        if self.has_deletes:
            raise ValueError(
                "delta carries deletes, which are overlay-ineligible "
                "outside plus_times; materialize via CSR.apply_delta")
        return self.rows, self.cols, self.vals

    def column_order(self) -> np.ndarray:
        """Permutation sorting entries by (col, row)."""
        return np.lexsort((self.rows, self.cols))

    def summary(self) -> str:
        return (f"EdgeDelta[{self.n_rows}x{self.n_cols}] "
                f"+{self.n_inserts} -{self.n_deletes}")


def csr_diff(old: CSR, new: CSR) -> EdgeDelta:
    """The delta turning `old` into `new`: `old.apply_delta(csr_diff(old,
    new))` reproduces `new` exactly; a changed stored value is a delete
    of the old value plus an insert of the new one.  This is how the
    serving engine derives operand deltas from an adjacency mutation.
    The keys are matched on `old`'s device; only the delta comes back."""
    if old.shape != new.shape:
        raise ValueError(f"shape mismatch: {old.shape} vs {new.shape}")
    ok = _keys(old, "csr_diff")
    nk = _keys(new, "csr_diff").to(ok.device)
    ov, nv = old.data, new.data.to(ok.device)
    in_new, pn = _member(ok, nk)
    in_old, po = _member(nk, ok)
    diff_old = in_new & (nv[pn] != ov) if nv.numel() else in_new
    diff_new = in_old & (ov[po] != nv) if ov.numel() else in_old
    del_mask = ~in_new | diff_old
    ins_mask = ~in_old | diff_new
    dk, ik = to_numpy(ok[del_mask]), to_numpy(nk[ins_mask])
    return EdgeDelta._build(
        np.concatenate([dk // old.n_cols, ik // old.n_cols]),
        np.concatenate([dk % old.n_cols, ik % old.n_cols]),
        np.concatenate([to_numpy(ov[del_mask]), to_numpy(nv[ins_mask])]),
        np.concatenate([np.ones(dk.size, bool), np.zeros(ik.size, bool)]),
        old.n_rows, old.n_cols)


def apply_delta(base: CSR, delta: EdgeDelta) -> CSR:
    """Materialise `base` + `delta` as a fresh canonical CSR on the
    base's device: deleted coordinates removed structurally (even a
    stored 0.0), inserts appended, the whole rebuilt through
    `CSR.from_coo`."""
    if delta.shape != base.shape:
        raise ValueError(f"shape mismatch: {base.shape} vs {delta.shape}")
    bk = _keys(base, "apply_delta")
    dmask = delta.deletes
    del_keys = _query(bk, delta.rows[dmask], delta.cols[dmask],
                      base.n_cols)
    found, pos = _member(del_keys, bk)
    if not bool(found.all()):
        missing = to_numpy(del_keys[~found][:5])
        raise ValueError(
            "delta deletes coordinates absent from the base: "
            f"{[(int(k // base.n_cols), int(k % base.n_cols)) for k in missing]}")
    keep = torch.ones(bk.shape, dtype=torch.bool, device=bk.device)
    keep[pos[found]] = False
    ins = ~dmask
    clash, _ = _member(_query(bk, delta.rows[ins], delta.cols[ins],
                              base.n_cols), bk[keep])
    if bool(clash.any()):
        raise ValueError("delta inserts coordinates already stored in the "
                         "base (delete first to change a value)")
    kept = to_numpy(bk[keep])
    vals = to_numpy(base.data[keep])
    rows = np.concatenate([kept // base.n_cols, delta.rows[ins]])
    cols = np.concatenate([kept % base.n_cols, delta.cols[ins]])
    v = np.concatenate([vals, delta.vals[ins].astype(vals.dtype)])
    return CSR.from_coo(rows, cols, v, base.n_rows, base.n_cols,
                        dtype=vals.dtype, device=base.device)


__all__ = ["EdgeDelta", "csr_lookup", "csr_diff", "apply_delta"]
