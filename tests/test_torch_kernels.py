"""Port vs reference: the four prepared-layout runners.

Each runner of the port (its kernel's plain version, on CPU tensors) is
held against the reference's `spmv_*_prepared` in Pallas interpret mode
on the same integer-valued operands: bit-identical under plus_times,
equal (±inf identities included) under min_plus, or_and and max_times.
The families cover nnz = 0, empty rows and a hub row whose nonzeros
straddle many segments.  The segmented layout's merge-path window table
is checked against a walk of the merge path, and a Python model of the
CUDA kernel's windows and carries against the plain version.  The CUDA
kernels themselves run in `test_torch_gpu.py` on the card.
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


def _merge_walk(row_ptr):
    """The merge path item by item: ('end', row) or ('nz', k)."""
    items = []
    for r in range(len(row_ptr) - 1):
        items += [("nz", k) for k in range(row_ptr[r], row_ptr[r + 1])]
        items.append(("end", r))
    return items


def test_seg_layout_window_table():
    """The HYB heavy stream goes to row order with each row keeping the
    container's column order; `win_row[w]` counts the row ends before
    window w on the merge path, and `split_rows` are the rows whose items
    lie in more than one window."""
    ref_csr, _ = int_operands("rmat", 256, 3, "plus_times")
    hyb = t_convert(port_csr(ref_csr), "hyb")
    seg = tkl.prepare_hyb(hyb, seg_len=16).heavy
    rows, cols = hyb.hrows.numpy(), hyb.hcols.numpy()
    order = np.lexsort((cols, rows))                  # row, then column
    assert np.array_equal(seg.cols.numpy(), cols[order])
    assert np.array_equal(seg.vals.numpy(), hyb.hvals.numpy()[order])
    ptr = seg.row_ptr.numpy()
    assert np.array_equal(np.diff(ptr), np.bincount(rows, minlength=256))
    items = _merge_walk(ptr)
    n_win = -(-len(items) // 16)
    assert seg.win_row.shape == (n_win + 1,)
    for w in range(n_win + 1):
        before = items[:w * 16]
        assert seg.win_row[w] == sum(kind == "end" for kind, _ in before)
    window_of = {}
    for pos, (kind, i) in enumerate(items):
        r = i if kind == "end" else int(np.searchsorted(ptr, i, "right")) - 1
        window_of.setdefault(r, set()).add(pos // 16)
    split = sorted(r for r, ws in window_of.items() if len(ws) > 1)
    assert seg.split_rows.tolist() == split and len(split) > 0
    for t in (seg.row_ptr, seg.win_row, seg.split_rows, seg.cols):
        assert t.dtype == torch.int32


def test_seg_layout_hub_spans_many_windows():
    """A hub row over every column, with a 4-item window, spans most of
    the windows; empty rows are items too, so no window holds more than
    4 rows and nonzeros together."""
    ref_csr, x = int_operands("single-dense-row", 48, 5, "plus_times")
    seg = tkl.prepare_csr_seg(port_csr(ref_csr), seg_len=4)
    ptr = seg.row_ptr.numpy()
    hub = int(np.argmax(np.diff(ptr)))
    assert hub in seg.split_rows.tolist()
    n_win = seg.win_row.shape[0] - 1
    first, last = (ptr[hub] + hub) // 4, (ptr[hub + 1] + hub) // 4
    assert last - first + 1 >= np.diff(ptr)[hub] // 4
    per_window = np.diff(seg.win_row.numpy())
    nnz_per_window = np.diff(np.minimum(np.arange(n_win + 1) * 4,
                                        48 + ptr[-1])) - per_window
    assert (per_window + nnz_per_window <= 4).all()


def _kernel_model(seg, x, sr, base, threads=8):
    """The CUDA kernel's two passes, item by item (`threads` per CTA in
    place of 256): products staged per window, each thread's run of
    items folded in order, a segmented scan over the threads (in warps
    of 4 here), two carries per window, then the split rows' parts
    folded lane-strided with an xor-butterfly.  Its values are what the
    kernel computes, order included."""
    add, mul, ident = (lambda a, b: sr.add(torch.tensor(a),
                                           torch.tensor(b)).item(),
                       lambda a, b: sr.mul(torch.tensor(a),
                                           torch.tensor(b)).item(),
                       sr.identity)
    L, warp = seg.window, 4
    ptr, wr = seg.row_ptr.tolist(), seg.win_row.tolist()
    vals, cols = seg.vals.tolist(), seg.cols.tolist()
    n_rows, nnz = seg.n_rows, len(vals)
    n_items, n_win = n_rows + nnz, len(wr) - 1
    y = [None] * n_rows
    head, tail = [None] * n_win, [None] * n_win

    def out(row, v):
        assert y[row] is None, "a row is written twice"
        y[row] = v if base is None else add(base[row].item(), v)

    for w in range(n_win):
        d0, d1 = w * L, min(w * L + L, n_items)
        i0, i1 = wr[w], wr[w + 1]
        k0, n_i = d0 - i0, i1 - i0
        n_k = d1 - i1 - k0
        n = n_i + n_k
        prod = [mul(vals[k0 + k], x[cols[k0 + k]].item()) for k in range(n_k)]
        rend = [ptr[i0 + 1 + r] - k0 for r in range(n_i)]
        ipt = -(-L // threads)
        carry, flag, firsts, heads, ends = [], [], [], [], []
        for t in range(threads):
            lo, hi = min(t * ipt, n), min(t * ipt + ipt, n)
            a, b = max(lo - n_k, 0), min(lo, n_i)
            while a < b:
                p = (a + b) // 2
                if rend[p] <= lo - p - 1:
                    a = p + 1
                else:
                    b = p
            i, k, s, hd, has_end = a, lo - a, ident, ident, False
            for _ in range(lo, hi):
                if i < n_i and rend[i] <= k:
                    if has_end:
                        out(i0 + i, s)
                    else:
                        hd, has_end = s, True
                    s, i = ident, i + 1
                else:
                    s, k = add(s, prod[k]), k + 1
            carry.append(s)
            flag.append(has_end or t == 0)
            firsts.append(a)
            heads.append(hd)
            ends.append(has_end)
        scan, f = list(carry), list(flag)
        for base_t in range(0, threads, warp):          # in-warp scan
            off = 1
            while off < warp:
                old_v, old_f = scan[:], f[:]
                for t in range(base_t + off, base_t + warp):
                    if not old_f[t]:
                        scan[t] = add(old_v[t - off], old_v[t])
                    f[t] = old_f[t] or old_f[t - off]
                off *= 2
        c, warp_in = ident, []
        for base_t in range(0, threads, warp):
            warp_in.append(c)
            last = base_t + warp - 1
            c = scan[last] if f[last] else add(c, scan[last])
        for t in range(threads):
            if not f[t]:
                scan[t] = add(warp_in[t // warp], scan[t])
        for t in range(threads):
            if ends[t]:
                v = add(scan[t - 1] if t else ident, heads[t])
                row = i0 + firsts[t]
                if row == i0 and ptr[i0] < k0:
                    head[w] = v
                else:
                    out(row, v)
        tail[w] = scan[-1]
    for row in seg.split_rows.tolist():
        wa, wb = (ptr[row] + row) // L, (ptr[row + 1] + row) // L
        parts = [tail[q] for q in range(wa, wb)] + [head[wb]]
        lanes = [ident] * 32
        for q, v in enumerate(parts):
            lanes[q % 32] = add(lanes[q % 32], v)
        for off in (16, 8, 4, 2, 1):
            lanes = [add(lanes[j], lanes[j ^ off]) for j in range(32)]
        out(row, lanes[0])
    assert None not in y, "a row is never written"
    return torch.tensor(y, dtype=torch.float32)


@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("family,n,window", [
    ("rmat", 256, 16), ("rmat", 256, 64), ("single-dense-row", 48, 4),
    ("empty-rows", 64, 8), ("fd", 64, 32), ("empty", 16, 4)])
def test_kernel_model_matches_plain_version(family, n, window, sr_name):
    """The model of the CUDA kernel's windows and carries equals the
    plain version exactly on integer operands under every semiring,
    HYB heavy streams joined with the light result (every row written
    once, light rows as base ⊕ identity)."""
    ref_csr, x = int_operands(family, n, 2, sr_name)
    sr = SEMIRINGS[sr_name]
    hyb = t_convert(port_csr(ref_csr), "hyb", fill=sr.pad_value)
    prep = tkl.prepare_hyb(hyb, seg_len=window, semiring=sr)
    xt = torch.from_numpy(x)
    base = tkl.spmv_ell_prepared(prep.light, xt, sr)
    want = tkl.spmv_csr_seg_prepared(prep.heavy, xt, sr, base=base)
    assert torch.equal(_kernel_model(prep.heavy, xt, sr, base), want)
    seg = tkl.prepare_csr_seg(port_csr(ref_csr), seg_len=window)
    assert torch.equal(_kernel_model(seg, xt, sr, None),
                       tkl.spmv_csr_seg_prepared(seg, xt, sr))
