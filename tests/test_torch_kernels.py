"""Port vs reference: the four prepared-layout runners.

Each runner of the port (its kernel's plain version, on CPU tensors) is
held against the reference's `spmv_*_prepared` in Pallas interpret mode
on the same integer-valued operands: bit-identical under plus_times,
equal (±inf identities included) under min_plus, or_and and max_times.
The families cover nnz = 0, empty rows and a hub row whose nonzeros
straddle many segments.  The CUDA kernels themselves run in
`test_torch_gpu.py` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import FAMILIES, SEMIRING_NAMES, int_operands, port_csr

from repro.graph.semiring import SEMIRINGS as R_SEMIRINGS
from repro.kernels import _layout as rkl
from repro.plan import convert as r_convert
from repro_torch.graph.semiring import SEMIRINGS
from repro_torch.kernels import KERNELS, _layout as tkl
from repro_torch.plan import convert as t_convert

CASES = [(f, s) for f in ("ell", "csr", "csr-seg", "hyb")
         for s in SEMIRING_NAMES] + [("dia", "plus_times")]


def _reference(fmt, csr, x, sr_name, seg_len):
    sr = None if sr_name == "plus_times" else R_SEMIRINGS[sr_name]
    pad = 0.0 if sr is None else sr.pad_value
    c = r_convert(csr, fmt, fill=pad)
    if fmt == "dia":
        return rkl.spmv_dia_prepared(rkl.prepare_dia(c), x, interpret=True)
    if fmt == "ell":
        prep, run = rkl.prepare_ell(c, pad_value=pad), rkl.spmv_ell_prepared
    elif fmt == "csr":
        prep, run = rkl.prepare_csr(c, pad_value=pad), rkl.spmv_csr_prepared
    elif fmt == "csr-seg":
        prep = rkl.prepare_csr_seg(c, seg_len=seg_len, pad_mult=8,
                                   pad_value=pad)
        run = rkl.spmv_csr_seg_prepared
    else:
        prep = rkl.prepare_hyb(c, seg_len=seg_len, pad_mult=8,
                               pad_value=pad)
        run = rkl.spmv_hyb_prepared
    return run(prep, x, interpret=True, semiring=sr)


def _port(fmt, csr, x, sr_name, seg_len):
    sr = SEMIRINGS[sr_name]
    c = t_convert(csr, fmt, fill=sr.pad_value)
    if fmt == "dia":
        return tkl.spmv_dia_prepared(tkl.prepare_dia(c), x)
    if fmt == "ell":
        return tkl.spmv_ell_prepared(tkl.prepare_ell(c, sr), x, sr)
    if fmt == "csr":
        return tkl.spmv_csr_prepared(tkl.prepare_csr(c, semiring=sr), x, sr)
    if fmt == "csr-seg":
        return tkl.spmv_csr_seg_prepared(
            tkl.prepare_csr_seg(c, seg_len=seg_len), x, sr)
    return tkl.spmv_hyb_prepared(
        tkl.prepare_hyb(c, seg_len=seg_len, semiring=sr), x, sr)


def _check(fmt, sr_name, family, n, seed, seg_len=512):
    ref_csr, x = int_operands(family, n, seed, sr_name)
    want = np.asarray(_reference(fmt, ref_csr, jnp.asarray(x), sr_name,
                                 seg_len))
    got = _port(fmt, port_csr(ref_csr), torch.from_numpy(x), sr_name,
                seg_len).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert np.array_equal(got, want), (fmt, sr_name, family, n)


@pytest.mark.parametrize("fmt,sr_name", CASES)
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [24, 64])
def test_runner_matches_reference(fmt, sr_name, family, n):
    _check(fmt, sr_name, family, n, seed=n)


@pytest.mark.parametrize("fmt,sr_name", CASES)
@pytest.mark.parametrize("family", ["fd", "rmat"])
def test_runner_matches_reference_at_1024(fmt, sr_name, family):
    """The main path's families at the tests' largest size."""
    _check(fmt, sr_name, family, 1024, seed=1)


@pytest.mark.parametrize("fmt", ["csr-seg", "hyb"])
@pytest.mark.parametrize("seg_len", [8, 16, 64])
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
def test_segment_carry_matches_reference(fmt, seg_len, sr_name):
    """A hub row cut across many short segments is stitched back exactly
    by the merge pass."""
    _check(fmt, sr_name, "single-dense-row", 48, seed=5, seg_len=seg_len)


def test_zero_row_matrix_runs_every_runner():
    z = np.array([], dtype=np.int64)
    from repro_torch.core.formats import CSR

    csr = CSR.from_coo(z, z, np.array([], np.float32), 0, 0, device="cpu")
    x = torch.zeros(0)
    for fmt, sr_name in CASES:
        assert _port(fmt, csr, x, sr_name, 512).shape == (0,)


@pytest.mark.parametrize("sr_name", ["min_plus"])
@pytest.mark.parametrize("fmt", ["ell", "hyb"])
def test_non_absorbing_padding_is_refused(fmt, sr_name):
    """An ELL/HYB container padded with 0.0 would turn its padding into
    weight-0 edges to vertex 0 under min_plus: refused."""
    ref_csr, _ = int_operands("empty-rows", 16, 2, sr_name)
    c = t_convert(port_csr(ref_csr), fmt, fill=0.0)
    prepare = tkl.prepare_ell if fmt == "ell" else tkl.prepare_hyb
    with pytest.raises(ValueError, match="absorbing"):
        prepare(c, semiring=SEMIRINGS[sr_name])


def test_dia_refuses_other_semirings_and_bad_x():
    ref_csr, x = int_operands("fd", 16, 0, "plus_times")
    prep = tkl.prepare_dia(t_convert(port_csr(ref_csr), "dia"))
    with pytest.raises(ValueError, match="plus-times"):
        tkl.spmv_dia_prepared(prep, torch.from_numpy(x), "min_plus")
    with pytest.raises(ValueError, match="shape"):
        tkl.spmv_dia_prepared(prep, torch.zeros(3))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """On CPU tensors a wrapper runs its plain version; a launch count
    moves only where a CUDA kernel is launched."""
    before = {k: fn.launches for k, fn in KERNELS.items()}
    for family in ("fd", "rmat"):
        ref_csr, x = int_operands(family, 256, 3, "plus_times")
        for fmt in ("dia", "ell", "csr", "hyb"):
            _port(fmt, port_csr(ref_csr), torch.from_numpy(x),
                  "plus_times", 512)
    assert {k: fn.launches for k, fn in KERNELS.items()} == before


def test_wrappers_refuse_inputs_on_mixed_devices():
    ref_csr, x = int_operands("fd", 16, 0, "plus_times")
    prep = tkl.prepare_ell(t_convert(port_csr(ref_csr), "ell"))
    with pytest.raises(ValueError, match="devices"):
        KERNELS["spmv_ell"](prep.data, prep.idx, torch.from_numpy(x)
                            .to("meta"), SEMIRINGS["plus_times"])


def test_seg_layout_ranks_and_merge_lists():
    """Ranks are dense per segment in ascending row order, `order` sorts
    each segment's slots by (rank, slot) without leaving the segment, and
    each row's partials are listed in segment order."""
    rows = np.array([3, 1, 3, 0, 2, 2, 1])
    seg = tkl.segment_stream(rows, np.arange(7), np.ones(7, np.float32), 4,
                             7, seg_len=3, device="cpu")
    assert seg.rid.tolist() == [1, 0, 1, 0, 1, 1, 0] and seg.rwin == 2
    assert seg.order.dtype == torch.int16
    assert seg.order.tolist() == [1, 0, 2, 0, 1, 2, 0]
    assert seg.long_rows.tolist() == []
    ptr, idx = seg.merge_ptr, seg.merge_idx
    # segment 0 ranks rows (1, 3); 1 ranks (0, 2); 2 ranks (1,)
    assert ptr.tolist() == [0, 1, 3, 4, 5]
    assert idx.tolist() == [2, 0, 4, 3, 1]


def test_seg_layout_lists_the_rows_with_long_merges():
    """A row with more than LONG_ROW partials (one per one-slot segment
    here) is listed for the block-per-row merge; a short row is not."""
    from repro_torch.kernels.spmv_csr_seg import LONG_ROW

    rows = np.array([5] * (LONG_ROW + 1) + [1] * LONG_ROW)
    seg = tkl.segment_stream(rows, np.arange(rows.size),
                             np.ones(rows.size, np.float32), 8, rows.size,
                             seg_len=1, device="cpu")
    assert seg.long_rows.tolist() == [5]
    want = torch.zeros(8)
    want[5], want[1] = LONG_ROW + 1, LONG_ROW
    got = tkl.spmv_csr_seg_prepared(seg, torch.ones(rows.size))
    assert torch.equal(got, want)
