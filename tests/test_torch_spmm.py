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
from repro_torch import reorder as treorder
from repro_torch.graph.semiring import SEMIRINGS
from repro_torch.kernels import (KERNELS, _layout as tkl, spmv_csr_seg_plain,
                                 spmv_ell_plain)
from repro_torch.kernels.spmv_ell import gather_layout
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


# ---------------------------------------------------------------------------
# the batched segmented kernel's lanes schedule, replayed on the CPU
# ---------------------------------------------------------------------------

def _lanes_model(seg, x, sr, base, threads=16, warp=4, chunk=8, depth=3):
    """`csrc/spmm_csr_seg.cu`'s lanes kernel for one column, item by item,
    with `threads` virtual threads a window in scan groups of `warp`
    (256 and 32 on the card) held `chunk` at a time (512 / G): each
    virtual thread's nonzeros gathered `depth` at a time and folded, the
    rows that end before a nonzero closed first; the chunk's carry-outs
    scanned group by group, the group totals folded in order across
    chunks, each head row joined with the previous virtual thread's scan
    (the previous chunk's last one kept), the chunk's rows stored after
    it; then pass 2's butterfly over split rows.  Its values are what the
    kernel computes, order included."""
    def add(a, b):
        return sr.add(torch.tensor(a), torch.tensor(b)).item()

    def mul(a, b):
        return sr.mul(torch.tensor(a), torch.tensor(b)).item()

    ident, L = sr.identity, seg.window
    ptr, wr = seg.row_ptr.tolist(), seg.win_row.tolist()
    vals, cols, xs = seg.vals.tolist(), seg.cols.tolist(), x.tolist()
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
        n = n_i + d1 - i1 - k0
        rend = [ptr[i0 + 1 + r] - k0 for r in range(n_i)]
        began_before = ptr[i0] < k0
        ipt = -(-L // threads)
        vfirst = []
        for v in range(threads + 1):
            lo = min(v * ipt, n)
            a, b = max(lo - (n - n_i), 0), min(lo, n_i)
            while a < b:
                p = (a + b) // 2
                if rend[p] <= lo - p - 1:
                    a = p + 1
                else:
                    b = p
            vfirst.append(a)
        acc, last = ident, None
        for v0 in range(0, threads, chunk):
            rb, ybuf = vfirst[v0], {}
            carry, heads, ends = [], [], []
            for v in range(v0, v0 + chunk):
                fnext = vfirst[v + 1]
                lo = min(v * ipt, n)
                hi = min(lo + ipt, n)
                i = vfirst[v]
                kk, kend = lo - i, hi - fnext
                st = dict(s=ident, hd=ident, has_end=False)

                def close_rows(i, kk, st=st, fnext=fnext, rb=rb, ybuf=ybuf):
                    while i < fnext and rend[i] <= kk:
                        if st["has_end"]:
                            assert i - rb not in ybuf
                            ybuf[i - rb] = st["s"]
                        else:
                            st["hd"], st["has_end"] = st["s"], True
                        st["s"] = ident
                        i += 1
                    return i

                while kk < kend:
                    nb = min(depth, kend - kk)
                    gathered = [xs[cols[k0 + kk + j]] for j in range(nb)]
                    for j in range(nb):
                        i = close_rows(i, kk)
                        st["s"] = add(st["s"], mul(vals[k0 + kk], gathered[j]))
                        kk += 1
                close_rows(i, kk)
                carry.append(st["s"])
                heads.append(st["hd"])
                ends.append(st["has_end"])
            scan = list(carry)
            f = [ends[j] or v0 + j == 0 for j in range(chunk)]
            for g0 in range(0, chunk, warp):
                off = 1
                while off < warp:
                    old_v, old_f = scan[:], f[:]
                    for j in range(g0 + off, g0 + warp):
                        if not old_f[j]:
                            scan[j] = add(old_v[j - off], old_v[j])
                        f[j] = old_f[j] or old_f[j - off]
                    off *= 2
            tin = []
            for g0 in range(0, chunk, warp):
                tin.append(acc)
                top = g0 + warp - 1
                acc = scan[top] if f[top] else add(acc, scan[top])
            for j in range(chunk):
                if not f[j]:
                    scan[j] = add(tin[j // warp], scan[j])
            for j in range(chunk):
                vg = v0 + j
                if ends[j]:
                    prev = ident if vg == 0 else scan[j - 1] if j else last
                    val = add(prev, heads[j])
                    fr = vfirst[vg]
                    if fr == 0 and began_before:
                        head[w] = val
                    else:
                        assert fr - rb not in ybuf
                        ybuf[fr - rb] = val
                if vg == threads - 1:
                    tail[w] = scan[j]
            last = scan[chunk - 1]
            for r in range(vfirst[v0 + chunk] - rb):
                if rb + r == 0 and began_before:
                    assert r not in ybuf
                    continue
                out(i0 + rb + r, ybuf[r])
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


LANES_CASES = [("rmat", 256, 16), ("rmat", 256, 64), ("single-dense-row", 48, 4),
               ("empty-rows", 64, 8), ("fd", 64, 32)]


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("family,n,window", LANES_CASES)
def test_lanes_model_matches_plain_version(family, n, window, sr_name, chunk):
    """The model of the lanes kernel's chunked schedule equals the plain
    version exactly on integer operands under every semiring, on a HYB
    heavy stream with the light result as its base and on a csr-seg
    stream, whatever the chunk (one scan group or all of them)."""
    ref_csr, x = int_operands(family, n, 2, sr_name)
    sr = SEMIRINGS[sr_name]
    hyb = t_convert(port_csr(ref_csr), "hyb", fill=sr.pad_value)
    prep = tkl.prepare_hyb(hyb, seg_len=window, semiring=sr)
    xt = torch.from_numpy(x)
    base = tkl.spmv_ell_prepared(prep.light, xt, sr)
    want = tkl.spmv_csr_seg_prepared(prep.heavy, xt, sr, base=base)
    assert torch.equal(_lanes_model(prep.heavy, xt, sr, base, chunk=chunk),
                       want)
    seg = tkl.prepare_csr_seg(port_csr(ref_csr), seg_len=window)
    assert torch.equal(_lanes_model(seg, xt, sr, None, chunk=chunk),
                       tkl.spmv_csr_seg_prepared(seg, xt, sr))


@pytest.mark.parametrize("chunk,depth", [(4, 1), (8, 3), (16, 8)])
@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus"])
@pytest.mark.parametrize("family,n,window", [("rmat", 256, 16),
                                             ("single-dense-row", 48, 4)])
def test_lanes_model_folds_as_the_columns_kernel(family, n, window, sr_name,
                                                 chunk, depth):
    """On real values with -0.0, ±inf and NaN the lanes schedule gives the
    bits of the single-column schedule (`test_torch_kernels._kernel_model`,
    the order `spmv_csr_seg` folds in): chunks and gather depth change
    which lane performs an ⊕, never the order."""
    from test_torch_kernels import _kernel_model

    ref_csr, _ = int_operands(family, n, 2, sr_name)
    sr = SEMIRINGS[sr_name]
    seg = tkl.prepare_csr_seg(port_csr(ref_csr), seg_len=window)
    x = _special_batch(1, seg.n_cols, seed=window)[0]
    base = _special_batch(1, seg.n_rows, seed=window + 1)[0]
    want = _kernel_model(seg, x, sr, base, threads=16)
    assert _same_bits(_lanes_model(seg, x, sr, base, chunk=chunk,
                                   depth=depth), want)


# ---------------------------------------------------------------------------
# how the batched ELL kernel reads X: chosen on the host from the slab
# ---------------------------------------------------------------------------

def _scrambled_band(n):
    band = tg.banded_matrix(n, 8, device="cpu")
    perm = np.random.default_rng(0).permutation(n)
    return treorder.Reordering(row_perm=perm, col_perm=perm).apply(band)


def _plan(m, fmt, reorder="none", sr_name="plus_times"):
    return tplan.compile(m, format=fmt, reorder=reorder, predictor="none",
                         semiring=sr_name, device="cpu")


def _slab_layout(plan):
    """The gather layout `spmm_ell` picks for an ell plan's slab or a
    hyb plan's light slab."""
    p = plan.prep if plan.format_name == "ell" else plan.prep.light
    return gather_layout(p.data, p.idx,
                             SEMIRINGS[plan.semiring].pad_value)


@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("log2n", [10, 12])
def test_gather_layout_follows_the_slab(log2n, sr_name):
    """FD's stencil and an RCM'd band read X as it lies; R-MAT's light
    slab and FD's slab with its columns shuffled gather rows of the
    interleaved copy."""
    n = 1 << log2n
    fd = _plan(tg.fd_matrix(n, device="cpu"), "ell", sr_name=sr_name)
    band = _plan(_scrambled_band(n), "ell", reorder="rcm", sr_name=sr_name)
    rmat = _plan(tg.rmat_matrix(n, device="cpu"), "hyb", sr_name=sr_name)
    assert _slab_layout(fd) == "direct"
    assert band.reordering is not None and _slab_layout(band) == "direct"
    assert _slab_layout(rmat) == "xt"
    p = fd.prep
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n)).to(
        torch.int32)
    shuffled = perm[p.idx.long()]
    assert gather_layout(p.data, shuffled,
                             SEMIRINGS[sr_name].pad_value) == "xt"
    # the scrambled band itself, before RCM, gathers at random
    assert _slab_layout(_plan(_scrambled_band(n), "ell",
                              sr_name=sr_name)) == "xt"


def test_gather_layout_counts_only_real_entries():
    """Padding slots (the absorbing value, column 0) do not count: a slab
    of random rows stays "xt" however much padding sits beside it, and a
    slab of padding only reads nothing ("direct")."""
    rng = np.random.default_rng(3)
    n, w = 4096, 4
    idx = torch.from_numpy(rng.integers(0, n, (w, n)).astype(np.int32))
    data = torch.ones(w, n)
    data[1:] = 0.0
    idx[1:] = 0
    data[0, rng.random(n) < 0.8] = 0.0
    assert gather_layout(data, idx, 0.0) == "xt"
    assert gather_layout(torch.zeros(w, n), torch.zeros_like(idx),
                             0.0) == "direct"
    assert gather_layout(torch.ones(w, n), idx, 0.0) == "xt"


@pytest.mark.parametrize("gather", ["direct", "xt"])
def test_gather_layout_is_derived_and_never_saved(tmp_path, gather):
    """The gather layout is derived from the slab and not kept with the
    plan: an FD ELL plan (direct) and an R-MAT HYB plan (xt) saved, loaded
    and saved again write the same bytes, the loaded slab picks the same
    layout, and `execute_many` gives the same bits."""
    if gather == "direct":
        p = _plan(tg.fd_matrix(1 << 10, device="cpu"), "ell")
    else:
        p = _plan(tg.rmat_matrix(1 << 10, device="cpu"), "hyb")
    assert _slab_layout(p) == gather
    tplan.save_plan(p, str(tmp_path / "a"))
    back, _ = tplan.load_plan(str(tmp_path / "a"), device="cpu")
    tplan.save_plan(back, str(tmp_path / "b"))
    files = sorted(q.relative_to(tmp_path / "a")
                   for q in (tmp_path / "a").rglob("*") if q.is_file())
    assert files
    for q in files:
        assert (tmp_path / "a" / q).read_bytes() == \
            (tmp_path / "b" / q).read_bytes()
    assert _slab_layout(back) == gather
    X = _real_batch("plus_times", 3, p.n_cols, 7)
    assert _same_bits(back.execute_many(X), p.execute_many(X))
