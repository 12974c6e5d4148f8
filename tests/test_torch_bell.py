"""Port vs reference: the BELL container, its prepared layout and the
plain version of the BELL kernel.

`BELL.from_csr` must give the reference's arrays byte for byte (so the
same fingerprint), duplicates and truncation included; the prepared
runner (the kernel's plain version on CPU tensors) must equal the
reference's `spmv_bell_prepared` in Pallas interpret mode bit for bit on
integer-valued operands, within rtol 1e-5 on real ones, and for every
x -- a padding block adds 0 * x[0:128], NaN where the first tile holds
a non-finite value.  The CUDA kernel itself runs in `test_torch_gpu.py`.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import blocked_coo, port_csr

from repro.core import formats as rf
from repro.core import generators as rg
from repro.core.spmv import spmv_bell_jnp
from repro.kernels import _layout as rkl
from repro.plan import compile as r_compile
from repro.plan import fingerprint as rfp
from repro_torch.core import formats as tf
from repro_torch.kernels import _layout as tkl
from repro_torch.kernels import ops as tops
from repro_torch.kernels.spmv_bell import column_mask, spmv_bell_torch
from repro_torch.plan import compile as t_compile
from repro_torch.plan import fingerprint as tfp


def _ref_csr(rows, cols, vals, n_rows, n_cols):
    return rf.CSR.from_coo(np.asarray(rows), np.asarray(cols),
                           np.asarray(vals, np.float32), n_rows, n_cols)


def _case(name):
    """(reference CSR, description) for each edge case of the slice."""
    rng = np.random.default_rng(5)
    if name == "blocked":
        return _ref_csr(*blocked_coo(1024, 12, 0), 1024, 1024)
    if name == "overlapping-tiles":        # 40 tiles in 32 slots: overlaps
        return _ref_csr(*blocked_coo(256, 40, 3), 256, 256)
    if name == "ragged-edges":             # n_rows % 8, n_cols % 128 != 0
        r = rng.integers(0, 1001, 3000)
        c = rng.integers(0, 300, 3000)
        return _ref_csr(r, c, rng.normal(size=3000), 1001, 300)
    if name == "empty-block-rows":         # nonzeros in two row bands only
        r = np.concatenate([rng.integers(0, 8, 500),
                            rng.integers(200, 216, 500)])
        c = rng.integers(0, 512, 1000)
        return _ref_csr(r, c, rng.normal(size=1000), 256, 512)
    if name == "nnz0":
        z = np.zeros(0, np.int64)
        return _ref_csr(z, z, np.zeros(0), 100, 200)
    if name == "rows0":
        z = np.zeros(0, np.int64)
        return _ref_csr(z, z, np.zeros(0), 0, 64)
    if name == "fd22":                     # C1: duplicate coordinates
        return rg.fd_matrix(22)
    if name == "dup3":                     # 4 duplicates whose f32 sum
        r = np.array([3, 3, 3, 3, 3, 9])   # depends on the order
        c = np.array([5, 5, 5, 5, 130, 5])
        v = np.array([1e8, 1.0, -1e8, 1.0, 2.0, 3.0])
        return _ref_csr(r, c, v, 16, 256)
    if name == "rmat":
        return rg.rmat_matrix(256, seed=4)
    raise ValueError(name)


CASES = ["blocked", "overlapping-tiles", "ragged-edges", "empty-block-rows",
         "nnz0", "rows0", "fd22", "dup3", "rmat"]


@pytest.mark.parametrize("bpr", [None, 1, 2])
@pytest.mark.parametrize("name", CASES)
def test_from_csr_byte_identical(name, bpr):
    ref_csr = _case(name)
    ref = rf.BELL.from_csr(ref_csr, blocks_per_row=bpr)
    got = tf.BELL.from_csr(port_csr(ref_csr), blocks_per_row=bpr)
    for a, b in ((ref.data, got.data), (ref.block_cols, got.block_cols)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        assert np.array_equal(a, b.numpy())
    assert (got.n_rows, got.n_cols, got.bm, got.bn, got.blocks_per_row) \
        == (ref.n_rows, ref.n_cols, ref.bm, ref.bn, ref.blocks_per_row)
    assert tfp.matrix_fingerprint(got) == rfp.matrix_fingerprint(ref)
    assert got.storage_bytes() == ref.storage_bytes()
    if ref.data.size:
        assert got.density() == ref.density()


def test_overlapping_tiles_make_duplicates():
    """The overlap case really exercises summed duplicates."""
    ref_csr = _case("overlapping-tiles")
    keys = np.repeat(np.arange(256), np.diff(np.asarray(ref_csr.indptr))) \
        * 256 + np.asarray(ref_csr.indices)
    assert np.unique(keys).size < keys.size


def _int_bell(ref_csr, seed):
    """The case's pattern with integer values in [-8, 8] \\ {0}."""
    vals = np.random.default_rng(seed).integers(-8, 9, ref_csr.nnz)
    vals[vals == 0] = 1
    c = rf.CSR(data=jnp.asarray(vals.astype(np.float32)),
               indices=ref_csr.indices, indptr=ref_csr.indptr,
               n_rows=ref_csr.n_rows, n_cols=ref_csr.n_cols)
    return c, rf.BELL.from_csr(c)


def _ref_run(bell, x):
    return np.asarray(rkl.spmv_bell_prepared(rkl.prepare_bell(bell),
                                             jnp.asarray(x), interpret=True))


def _port_run(ref_csr, x):
    bell = tf.BELL.from_csr(port_csr(ref_csr))
    return tkl.spmv_bell_prepared(tkl.prepare_bell(bell),
                                  torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("name", [c for c in CASES if c != "rows0"])
def test_plain_version_bit_identical_on_integers(name):
    c, ref_bell = _int_bell(_case(name), 1)
    x = np.random.default_rng(2).integers(-8, 9, c.n_cols) \
        .astype(np.float32)
    want = _ref_run(ref_bell, x)
    got = _port_run(c, x)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["blocked", "ragged-edges", "rmat",
                                  "dup3"])
def test_plain_version_real_values_within_tolerance(name):
    c = _case(name)
    x = np.random.default_rng(3).normal(size=c.n_cols).astype(np.float32)
    want = _ref_run(rf.BELL.from_csr(c), x)
    np.testing.assert_allclose(_port_run(c, x), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("name", ["blocked", "empty-block-rows", "nnz0"])
def test_non_finite_first_tile_poisons_padded_rows(name, bad):
    """A padding block adds 0 * x[0:128]: with a non-finite value in the
    first tile, every row of a padded block row is NaN in the reference,
    and so in the port; rows of unpadded block rows are not."""
    c, ref_bell = _int_bell(_case(name), 4)
    x = np.ones(c.n_cols, np.float32)
    x[min(5, c.n_cols - 1)] = bad
    want = _ref_run(ref_bell, x)
    got = _port_run(c, x)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any()
    fin = ~np.isnan(want)
    assert np.array_equal(got[fin], want[fin])


def test_prepared_layout_keeps_real_blocks_and_their_kept_columns():
    """The blocked matrix's padded container is mostly padding; the
    prepared layout stores the real blocks, flags the padded rows, and
    of each block only its kept columns (a 128-bit mask), column by
    column, at its int64 value offset."""
    c = _case("empty-block-rows")
    bell = tf.BELL.from_csr(port_csr(c))
    prep = tkl.prepare_bell(bell)
    nonzero = (bell.data != 0).flatten(2).any(2)
    real = int(nonzero.sum())
    counts = torch.diff(prep.block_ptr.long())
    assert prep.masks.shape == (real, 4) and int(counts.sum()) == real
    assert torch.equal(prep.pad0.bool(), counts < bell.blocks_per_row)
    blocks = bell.data[nonzero]                       # (real, 8, 128)
    kept = column_mask(prep.masks)
    assert torch.equal(kept, (blocks != 0).any(dim=1))
    k = kept.sum(dim=1)
    assert torch.equal(prep.val_ptr, torch.cumsum(8 * k, 0) - 8 * k)
    for p in range(real):
        got = prep.values[prep.val_ptr[p]:prep.val_ptr[p] + 8 * k[p]]
        assert torch.equal(got.reshape(-1, 8), blocks[p][:, kept[p]].t())
    assert (prep.values.dtype, prep.val_ptr.dtype, prep.masks.dtype,
            prep.block_ptr.dtype, prep.pad0.dtype) == (
        torch.float32, torch.int64, torch.int32, torch.int32, torch.uint8)


def _transposed_blocked(n=1024, tiles=12, seed=0):
    """The PageRank operand's shape: dense 8x128 tiles transposed, so a
    BELL block holds 8 nonzero columns of 128; integer values."""
    rows, cols, _ = blocked_coo(n, tiles, seed)
    vals = np.random.default_rng(seed).integers(1, 9, rows.size)
    return _ref_csr(cols, rows, vals, n, n)


def test_transposed_tiles_keep_eight_columns_per_block():
    c = _transposed_blocked()
    prep = tkl.prepare_bell(tf.BELL.from_csr(port_csr(c)))
    k = column_mask(prep.masks).sum(dim=1)
    assert int(k.min()) >= 1 and int(k.max()) <= 16 and \
        float(k.float().mean()) < 9
    dense = prep.masks.shape[0] * 8 * 128 * 4
    assert prep.values.numel() * 4 < dense / 8
    # one lane a row: a warp walks four block rows of 8 at once
    assert prep.lanes == 1
    assert tkl.prepare_bell(tf.BELL.from_csr(port_csr(_case("blocked")))) \
        .lanes == 4


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_plain_version_fold_order_per_lane_count(lanes):
    """The plain version follows the kernel's fold for any lanes per
    row: integer sums are exact whatever the order, so each count gives
    the reference's result."""
    c, ref_bell = _int_bell(_case("overlapping-tiles"), 2)
    x = np.random.default_rng(5).integers(-8, 9, c.n_cols) \
        .astype(np.float32)
    prep = dataclasses.replace(
        tkl.prepare_bell(tf.BELL.from_csr(port_csr(c))), lanes=lanes)
    got = tkl.spmv_bell_prepared(prep, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, _ref_run(ref_bell, x))


def _nan_case(where, bad, seed=3):
    """x with one non-finite entry on the transposed tiles: in a column
    that some block drops, in a column some block keeps, or in tile 0
    (the padded block rows' term)."""
    c = _transposed_blocked(seed=seed)
    ref_bell = rf.BELL.from_csr(c)
    prep = tkl.prepare_bell(tf.BELL.from_csr(port_csr(c)))
    kept = column_mask(prep.masks)
    cols = prep.block_cols.long()
    if where == "tile 0":
        j = 5
        assert bool(prep.pad0.any())
    else:
        want_kept = where == "kept column"
        p = int(torch.nonzero(cols > 0)[0])
        n = int(torch.nonzero(kept[p] == want_kept)[0])
        j = int(cols[p]) * 128 + n
    x = np.random.default_rng(seed).integers(-8, 9, c.n_cols) \
        .astype(np.float32)
    x[j] = bad
    return ref_bell, c, x


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("where", ["dropped column", "kept column",
                                   "tile 0"])
def test_non_finite_x_on_transposed_tiles_matches_reference(where, bad):
    """The reference multiplies whole 8x128 blocks, so a non-finite x in
    a dropped column still makes NaN of every row of the blocks over it;
    in a kept column the stored products (explicit zeros included) do
    it; in tile 0 the padded block rows get NaN.  The port reads only
    kept columns and must give the same NaN rows and the same values."""
    ref_bell, c, x = _nan_case(where, bad)
    want = _ref_run(ref_bell, x)
    got = _port_run(c, x)
    assert np.isnan(want).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert np.array_equal(got[fin], want[fin])


def test_explicit_zero_in_a_kept_column_is_multiplied():
    """An explicit zero in a kept column stays stored: 0 * inf is NaN in
    its row (and in the block's rows with no entry there), while the row
    whose entry there is nonzero gets inf -- as in the reference's dense
    block."""
    r = np.array([0, 1, 1])
    col = np.array([3, 3, 4])
    c = _ref_csr(r, col, np.array([0.0, 2.0, 1.0]), 8, 128)
    x = np.ones(128, np.float32)
    x[3] = np.inf
    want = _ref_run(rf.BELL.from_csr(c), x)
    got = _port_run(c, x)
    assert np.isnan(want[0]) and np.isnan(got[0])
    assert want[1] == got[1] == np.inf
    assert np.isnan(want[2:]).all() and np.isnan(got[2:]).all()


@pytest.mark.parametrize("name", ["blocked", "ragged-edges", "nnz0"])
def test_container_oracle_matches_reference_jnp(name):
    """`spmv_bell_torch` (the use_pallas=False path) against
    `spmv_bell_jnp`, one vector and a batch."""
    c, ref_bell = _int_bell(_case(name), 6)
    x = np.random.default_rng(7).integers(-8, 9, (3, c.n_cols)) \
        .astype(np.float32)
    bell = tf.BELL.from_csr(port_csr(c))
    for row in x:
        want = np.asarray(spmv_bell_jnp(ref_bell, jnp.asarray(row)))
        got = spmv_bell_torch(bell, torch.from_numpy(row)).numpy()
        assert np.array_equal(got, want)
    batch = spmv_bell_torch(bell, torch.from_numpy(x)).numpy()
    assert np.array_equal(batch, np.stack(
        [np.asarray(spmv_bell_jnp(ref_bell, jnp.asarray(r))) for r in x]))


def test_ops_wrapper_and_compiled_plan_agree():
    c, ref_bell = _int_bell(_case("blocked"), 8)
    x = np.random.default_rng(9).integers(-8, 9, c.n_cols) \
        .astype(np.float32)
    want = _ref_run(ref_bell, x)
    got = tops.spmv_bell(tf.BELL.from_csr(port_csr(c)),
                         torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    p = t_compile(port_csr(c), format="bell", device="cpu")
    rp = r_compile(c, format="bell", reorder="none", predictor="none")
    assert p.format_name == rp.format_name == "bell"
    assert np.array_equal(p.execute(torch.from_numpy(x)).numpy(), want)
    assert np.array_equal(np.asarray(rp.execute(jnp.asarray(x))), want)


@pytest.mark.parametrize("sr", ["min_plus", "or_and", "max_times"])
def test_semiring_plan_with_bell_raises(sr):
    c = port_csr(_case("blocked"))
    with pytest.raises(ValueError, match="requires a format"):
        t_compile(c, semiring=sr, format="bell", device="cpu")
    with pytest.raises(ValueError, match="requires a format"):
        r_compile(_case("blocked"), semiring=sr, format="bell")


def test_prepared_runner_refuses_other_semirings_and_widths():
    bell = tf.BELL.from_csr(port_csr(_case("blocked")))
    prep = tkl.prepare_bell(bell)
    with pytest.raises(ValueError, match="plus-times only"):
        tkl.spmv_bell_prepared(prep, torch.ones(1024), "min_plus")
    narrow = tf.BELL.from_csr(port_csr(_case("blocked")), bn=64)
    with pytest.raises(ValueError, match="128 wide"):
        tkl.prepare_bell(narrow)
