"""Port vs reference: `execute_many` as one batched SpMM.

On an 'ell', 'hyb' or 'csr-seg' kernel plan `SpmvPlan.execute_many`
runs the batched runners (`spmm_*_prepared`), whose wrappers launch one
batched kernel on the card and run the (k, n) forms of the plain
versions on the CPU.  Here:

  * the batched plain versions (`spmv_ell_plain`, `spmv_csr_seg_plain`
    on a (k, n) batch with a (k, n_rows) base) and the batched runners
    equal the per-row ones bit for bit, for every semiring and k in
    {1, 3, 4, 64}, with X mixing -0.0, ±inf and NaN (compared as bits,
    so NaN payloads and the sign of zero count);
  * FD, R-MAT, reordered and overlaid kernel plans at <= 2^12: their
    `execute_many` equals the reference's (`repro.plan.SpmvPlan.
    execute_many`, its jnp kernel vmapped) on integer-valued operands
    exactly, as `tests/test_torch_plan.py` holds it, and each row equals
    `execute` of that row bit for bit, on real-valued X too.

The batched CUDA kernels themselves run in `test_torch_gpu.py`.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (SEMIRING_NAMES, coo_of, fresh_coords,
                           int_operands, port_csr)

from repro import plan as rplan
from repro.core import delta as rdelta
from repro_torch import plan as tplan
from repro_torch.core import delta as tdelta
from repro_torch.core import generators as tg
from repro_torch.graph.semiring import SEMIRINGS
from repro_torch.kernels import (KERNELS, _layout as tkl, spmv_csr_seg_plain,
                                 spmv_ell_plain)
from repro_torch.plan import convert as t_convert

roverlay = importlib.import_module("repro.plan.overlay")
toverlay = importlib.import_module("repro_torch.plan.overlay")

KS = (1, 3, 4, 64)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _special_batch(k: int, n: int, seed: int) -> torch.Tensor:
    """Real values in [-4, 4) with -0.0, +0.0, ±inf and NaN mixed in."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-4, 4, (k, n)).astype(np.float32)
    specials = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan], np.float32)
    pick = rng.random((k, n)) < 0.15
    X[pick] = rng.choice(specials, int(pick.sum()))
    return torch.from_numpy(X)


def _layouts(family: str, sr_name: str):
    ref, _ = int_operands(family, 256, 3, sr_name)
    sr = SEMIRINGS[sr_name]
    csr = port_csr(ref)
    ell = tkl.prepare_ell(t_convert(csr, "ell", fill=sr.pad_value), sr)
    seg = tkl.prepare_csr_seg(csr, seg_len=64)
    hyb = tkl.prepare_hyb(t_convert(csr, "hyb", fill=sr.pad_value),
                          seg_len=64, semiring=sr)
    return sr, ell, seg, hyb


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("family", ["fd", "rmat"])
def test_batched_plain_versions_equal_per_row_bit_for_bit(family, sr_name,
                                                          k):
    sr, ell, seg, _ = _layouts(family, sr_name)
    X = _special_batch(k, ell.n_cols, seed=k)
    base = _special_batch(k, seg.n_rows, seed=k + 100)
    Y = spmv_ell_plain(ell.data, ell.idx, X, sr)
    assert _same_bits(Y, torch.stack(
        [spmv_ell_plain(ell.data, ell.idx, x, sr) for x in X]))
    for b in (None, base):
        Y = spmv_csr_seg_plain(seg, X, sr, b)
        want = torch.stack([
            spmv_csr_seg_plain(seg, X[c], sr, None if b is None else b[c])
            for c in range(k)])
        assert _same_bits(Y, want)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("family", ["fd", "rmat", "single-dense-row"])
def test_batched_runners_equal_per_row_runners(family, sr_name, k):
    """`spmm_*_prepared` on CPU tensors: each row is its
    `spmv_*_prepared`, bit for bit, and no launch is counted."""
    sr, ell, seg, hyb = _layouts(family, sr_name)
    X = _special_batch(k, ell.n_cols, seed=2 * k)
    base = _special_batch(k, seg.n_rows, seed=3 * k)
    before = {name: fn.launches for name, fn in KERNELS.items()}
    cases = [
        (tkl.spmm_ell_prepared(ell, X, sr),
         [tkl.spmv_ell_prepared(ell, x, sr) for x in X]),
        (tkl.spmm_csr_seg_prepared(seg, X, sr, base=base),
         [tkl.spmv_csr_seg_prepared(seg, X[c], sr, base=base[c])
          for c in range(k)]),
        (tkl.spmm_hyb_prepared(hyb, X, sr),
         [tkl.spmv_hyb_prepared(hyb, x, sr) for x in X]),
    ]
    for got, rows in cases:
        assert got.shape == (k, ell.n_rows)
        assert _same_bits(got, torch.stack(rows))
    assert {name: fn.launches for name, fn in KERNELS.items()} == before


def test_batched_runners_refuse_bad_shapes():
    sr, ell, seg, hyb = _layouts("fd", "plus_times")
    X = torch.ones(2, ell.n_cols)
    for run, prep in ((tkl.spmm_ell_prepared, ell),
                      (tkl.spmm_csr_seg_prepared, seg),
                      (tkl.spmm_hyb_prepared, hyb)):
        with pytest.raises(ValueError, match="shape"):
            run(prep, X[0], sr)
        with pytest.raises(ValueError, match="shape"):
            run(prep, torch.ones(2, ell.n_cols + 1), sr)


def _int_batch(sr_name: str, k: int, n: int, seed: int) -> np.ndarray:
    """Integer-valued X in the semiring's domain (min_plus: some +inf)."""
    rng = np.random.default_rng(seed)
    if sr_name == "or_and":
        X = rng.integers(0, 2, (k, n))
    elif sr_name == "max_times":
        X = rng.integers(0, 9, (k, n))
    else:
        X = rng.integers(-8, 9, (k, n))
    X = X.astype(np.float32)
    if sr_name == "min_plus":
        X[rng.random((k, n)) < 0.05] = np.inf
    return X


def _real_batch(sr_name: str, k: int, n: int, seed: int) -> torch.Tensor:
    """Real-valued X in the semiring's domain (min_plus: some +inf)."""
    X = torch.from_numpy(np.random.default_rng(seed).uniform(
        0 if sr_name in ("or_and", "max_times") else -1, 1,
        (k, n)).astype(np.float32))
    if sr_name == "min_plus":
        X[::2, ::7] = float("inf")
    return X


def _check_plan(tp, rp, sr_name, k, seed):
    """`execute_many` equals the reference's on integer X; rows equal
    `execute` bit for bit on integer and real X; a replay is equal."""
    Xi = _int_batch(sr_name, k, tp.n_cols, seed)
    want = np.asarray(rp.execute_many(jnp.asarray(Xi)))
    got = tp.execute_many(torch.from_numpy(Xi))
    assert got.shape == (k, tp.n_rows)
    assert np.array_equal(got.numpy(), want)
    Xr = _real_batch(sr_name, k, tp.n_cols, seed + 1)
    for X in (torch.from_numpy(Xi), Xr):
        Y = tp.execute_many(X)
        assert _same_bits(tp.execute_many(X), Y)
        assert all(_same_bits(tp.execute(X[c]), Y[c]) for c in range(k))


PLAN_CASES = [
    ("fd", 1 << 12, "ell", "none", sr) for sr in SEMIRING_NAMES] + [
    ("rmat", 1 << 12, "hyb", "none", sr) for sr in SEMIRING_NAMES] + [
    ("rmat", 1 << 10, "csr-seg", "none", sr) for sr in SEMIRING_NAMES] + [
    ("fd", 1 << 10, "ell", "rcm", "min_plus"),
    ("rmat", 1 << 10, "hyb", "rcm", "plus_times"),
    ("rmat", 1 << 10, "csr-seg", "rcm", "or_and")]


@pytest.mark.parametrize("family,n,fmt,reorder,sr_name", PLAN_CASES)
def test_card_plans_execute_many_matches_reference(family, n, fmt, reorder,
                                                   sr_name):
    ref, _ = int_operands(family, n, 6, sr_name)
    kw = dict(format=fmt, reorder=reorder, predictor="none",
              semiring=sr_name)
    rp = rplan.compile(ref, **kw)
    tp = tplan.compile(port_csr(ref), device="cpu", **kw)
    assert tp.format_name == rp.format_name == fmt
    assert (tp.reordering is None) == (reorder == "none")
    for k in (1, 4, 5):
        _check_plan(tp, rp, sr_name, k, seed=10 * k)


def _int_delta(D, csr, seed, sr_name):
    """Integer-valued inserts in the semiring's domain and, under
    plus_times, deletes (the streaming tests' scheme)."""
    rng = np.random.default_rng(seed)
    ins = [(r, c, 1.0 if sr_name == "or_and" else float(rng.integers(1, 9)))
           for r, c in fresh_coords(csr, 6, rng)]
    dels = []
    if sr_name == "plus_times":
        rows, cols, _ = coo_of(csr)
        dels = [(int(rows[p]), int(cols[p]))
                for p in rng.choice(rows.size, 4, replace=False)]
    return D.EdgeDelta.from_updates(csr, inserts=ins, deletes=dels)


@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("family,fmt,reorder", [
    ("rmat", "hyb", "none"), ("fd", "ell", "none"), ("rmat", "hyb", "rcm")])
def test_overlaid_plans_execute_many_matches_reference(family, fmt, reorder,
                                                       sr_name):
    """An overlay rides on its base's batched `execute_many`: equal to
    the reference's overlay, rows equal to its `execute`."""
    ref, _ = int_operands(family, 1 << 10, 8, sr_name)
    port = port_csr(ref)
    kw = dict(format=fmt, reorder=reorder, predictor="none",
              semiring=sr_name)
    r_ov = roverlay.overlay(rplan.compile(ref, **kw),
                            _int_delta(rdelta, ref, 9, sr_name),
                            staleness_budget=1.0)
    t_ov = toverlay.overlay(tplan.compile(port, device="cpu", **kw),
                            _int_delta(tdelta, port, 9, sr_name),
                            staleness_budget=1.0)
    assert t_ov.fingerprint == r_ov.fingerprint
    _check_plan(t_ov, r_ov, sr_name, 4, seed=3)


@pytest.mark.parametrize("fmt", ["ell", "hyb", "csr-seg"])
def test_execute_many_on_the_generators_rows_equal_execute(fmt):
    """The port's own generators at 2^12, real-valued X of 64 rows (the
    serving engine's widest lane bucket): rows bit-equal to `execute`,
    and an empty batch gives (0, n_rows)."""
    m = (tg.fd_matrix if fmt == "ell" else tg.rmat_matrix)(
        1 << 12, device="cpu")
    p = tplan.compile(m, format=fmt, reorder="none", predictor="none",
                      device="cpu")
    X = _real_batch("plus_times", 64, p.n_cols, 4)
    Y = p.execute_many(X)
    assert all(_same_bits(p.execute(X[c]), Y[c]) for c in range(64))
    assert p.execute_many(X[:0]).shape == (0, p.n_rows)
