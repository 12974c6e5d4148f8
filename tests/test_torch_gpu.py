"""The hand-written CUDA kernels on the card, against their plain
versions.  Every test needs a CUDA card and skips without one (the
decision is made in the `cuda` fixture, never at import).  Run them on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import (FAMILIES, SEMIRING_NAMES, blocked_coo, coo_of,
                           fresh_coords, port_int_operands, within_bf16_ulp)

from repro_torch.graph import drivers as tdrv
from repro_torch.graph.semiring import SEMIRINGS
from repro_torch.kernels import (KERNELS, _layout as tkl, launch_counts,
                                 reset_launch_counts)
from repro_torch.kernels.spmv_ell import gather_layout
from repro_torch.core.formats import BELL, CSR
from repro_torch.plan import compile as tcompile, convert

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode (their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _layouts(fmt, csr, sr, seg_len=512):
    c = convert(csr, fmt, fill=sr.pad_value)
    if fmt == "dia":
        return tkl.prepare_dia(c), tkl.spmv_dia_prepared
    if fmt == "ell":
        return tkl.prepare_ell(c, sr), tkl.spmv_ell_prepared
    if fmt == "csr":
        return tkl.prepare_csr(c, n_stripes=3, semiring=sr), \
            tkl.spmv_csr_prepared
    if fmt == "csr-seg":
        return tkl.prepare_csr_seg(c, seg_len=seg_len), \
            tkl.spmv_csr_seg_prepared
    return tkl.prepare_hyb(c, seg_len=seg_len, semiring=sr), \
        tkl.spmv_hyb_prepared


CASES = [(f, s) for f in ("ell", "csr", "csr-seg", "hyb")
         for s in SEMIRING_NAMES] + [("dia", "plus_times")]


@pytest.mark.parametrize("fmt,sr_name", CASES)
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_matches_plain_version_bit_for_bit(cuda, fmt, sr_name,
                                                  family):
    """Integer-valued operands: the CUDA result equals the plain version
    run on the CPU exactly, ±inf included, and a launch is counted."""
    csr, x = port_int_operands(family, 300, 11, sr_name)
    sr = SEMIRINGS[sr_name]
    cpu_prep, run = _layouts(fmt, csr, sr, seg_len=64)
    gpu_prep, _ = _layouts(fmt, csr.to(cuda), sr, seg_len=64)
    want = run(cpu_prep, torch.from_numpy(x), sr)
    reset_launch_counts()
    got = run(gpu_prep, torch.from_numpy(x).to(cuda), sr)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert sum(launch_counts().values()) >= 1


@pytest.mark.parametrize("window", [4, 16])
@pytest.mark.parametrize("fmt", ["csr-seg", "hyb"])
@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
def test_hub_rows_spanning_many_windows(cuda, fmt, sr_name, window):
    """Hub rows cut across many merge-path windows are folded from their
    carries by the second pass and still equal the plain version
    exactly; the layout has split rows whose parts span more than 32
    windows (every lane of the folding warp takes several)."""
    csr, x = port_int_operands("single-dense-row", 300, 11, sr_name)
    sr = SEMIRINGS[sr_name]
    cpu_prep, run = _layouts(fmt, csr, sr, seg_len=window)
    heavy = cpu_prep if fmt == "csr-seg" else cpu_prep.heavy
    ptr = heavy.row_ptr.long()
    rows = heavy.split_rows.long()
    spans = (ptr[rows + 1] + rows) // window - (ptr[rows] + rows) // window
    assert rows.numel() > 0 and int(spans.max()) > (32 if window == 4
                                                    else 8)
    gpu_prep, _ = _layouts(fmt, csr.to(cuda), sr, seg_len=window)
    want = run(cpu_prep, torch.from_numpy(x), sr)
    got = run(gpu_prep, torch.from_numpy(x).to(cuda), sr)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("window", [64, 2048, 4096])
def test_segmented_kernel_on_rmat_windows(cuda, window):
    """R-MAT's HYB heavy stream at 2^14 rows under every semiring, with
    integer values, and with real values within rtol 1e-5; two launches
    are bit-identical."""
    from repro_torch.core.generators import rmat_matrix

    for sr_name in SEMIRING_NAMES:
        sr = SEMIRINGS[sr_name]
        csr, x = port_int_operands("rmat", 1 << 14, 2, sr_name)
        prep, run = _layouts("hyb", csr.to(cuda), sr, seg_len=window)
        xt = torch.from_numpy(x).to(cuda)
        got = run(prep, xt, sr)
        plain = run(_layouts("hyb", csr, sr, seg_len=window)[0],
                    torch.from_numpy(x), sr)
        assert torch.equal(got.cpu(), plain), sr_name
    csr = rmat_matrix(1 << 14, device=cuda)
    sr = SEMIRINGS["plus_times"]
    prep, run = _layouts("hyb", csr, sr, seg_len=window)
    x = torch.rand(1 << 14, device=cuda)
    got = run(prep, x, sr)
    assert torch.equal(run(prep, x, sr), got)
    plain = tcompile(csr, format="hyb", use_pallas=False, reorder="none",
                     predictor="none", device=cuda).execute(x)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fmt", ["dia", "ell", "csr", "hyb"])
def test_kernel_real_valued_plus_times_within_tolerance(cuda, fmt):
    """Real values: the kernels' summation order differs from the
    container oracle's (ordered sums, but in another order), so rtol
    1e-5."""
    from repro_torch.core.generators import rmat_matrix, fd_matrix

    csr = (fd_matrix if fmt == "dia" else rmat_matrix)(4096, device=cuda)
    sr = SEMIRINGS["plus_times"]
    prep, run = _layouts(fmt, csr, sr)
    x = torch.rand(4096, device=cuda)
    got = run(prep, x, sr)
    plain = tcompile(csr, format=fmt, use_pallas=False, reorder="none",
                     predictor="none", device=cuda).execute(x)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)


def test_each_wrapper_counts_only_its_launches(cuda):
    csr = port_int_operands("rmat", 256, 1, "plus_times", device=cuda)[0]
    reset_launch_counts()
    p = tcompile(csr, reorder="none", predictor="none", device=cuda)  # hyb
    p.execute(torch.ones(256, device=cuda))
    assert launch_counts() == {"spmv_dia": 0, "spmv_ell": 1, "spmv_csr": 0,
                               "spmv_csr_seg": 1, "spmv_bell": 0,
                               "spmm_ell": 0, "spmm_csr_seg": 0,
                               "flash_attention": 0, "paged_attention": 0}
    p.execute_many(torch.ones(2, 256, device=cuda))     # one batched SpMM
    assert launch_counts()["spmm_ell"] == 1 and \
        launch_counts()["spmm_csr_seg"] == 1
    assert sum(launch_counts().values()) == 4
    assert set(KERNELS) == set(launch_counts())


@pytest.mark.parametrize("family", ["fd", "rmat"])
@pytest.mark.parametrize("analytic,kw", [
    ("pagerank", {"tol": 1e-6}), ("bfs", {"source": 0}),
    ("sssp", {"source": 0}), ("connected_components", {})])
def test_drivers_on_the_card_match_the_cpu(cuda, family, analytic, kw):
    from repro_torch.core.generators import fd_matrix, rmat_matrix

    gen = fd_matrix if family == "fd" else rmat_matrix
    a = tdrv.DRIVERS[analytic](gen(1024, device="cpu"), device="cpu", **kw)
    b = tdrv.DRIVERS[analytic](gen(1024, device=cuda), device=cuda, **kw)
    assert b.n_iters == a.n_iters and b.plan.device.type == "cuda"
    if analytic == "pagerank":
        np.testing.assert_allclose(b.values, a.values, rtol=0, atol=1e-6)
    else:
        assert np.array_equal(b.values, a.values)


# ---------------------------------------------------------------------------
# BELL
# ---------------------------------------------------------------------------

def _bell_case(name, device):
    """Integer-valued CSRs for the BELL kernel's edge cases."""
    rng = np.random.default_rng(5)
    if name == "blocked":
        rows, cols, _ = blocked_coo(1024, 12, 0)
        n_rows, n_cols = 1024, 1024
    elif name == "overlapping-tiles":
        rows, cols, _ = blocked_coo(256, 40, 3)
        n_rows, n_cols = 256, 256
    elif name == "ragged-edges":           # n_rows % 8, n_cols % 128 != 0
        rows, cols = rng.integers(0, 1001, 3000), rng.integers(0, 300, 3000)
        n_rows, n_cols = 1001, 300
    elif name == "empty-block-rows":
        rows = np.concatenate([rng.integers(0, 8, 500),
                               rng.integers(200, 216, 500)])
        cols, n_rows, n_cols = rng.integers(0, 512, 1000), 256, 512
    elif name == "nnz0":
        rows = cols = np.zeros(0, np.int64)
        n_rows, n_cols = 100, 200
    else:                                  # rows0
        rows = cols = np.zeros(0, np.int64)
        n_rows, n_cols = 0, 64
    vals = rng.integers(-8, 9, len(rows)).astype(np.float32)
    vals[vals == 0] = 1
    return CSR.from_coo(rows, cols, vals, n_rows, n_cols, device=device)


BELL_CASES = ["blocked", "overlapping-tiles", "ragged-edges",
              "empty-block-rows", "nnz0", "rows0"]


@pytest.mark.parametrize("kind", ["int", "real"])
@pytest.mark.parametrize("name", BELL_CASES)
def test_bell_kernel_matches_plain_version_bit_for_bit(cuda, name, kind):
    """The plain version repeats the kernel's summation order, so the two
    agree bit for bit on integer and on real values; one launch is
    counted (none for 0 rows)."""
    prep = tkl.prepare_bell(BELL.from_csr(_bell_case(name, cuda)))
    if kind == "real":
        prep = dataclasses.replace(prep, values=torch.rand(
            prep.values.shape, device=cuda) * (prep.values != 0))
    gen = torch.Generator().manual_seed(1)
    x = (torch.randint(-8, 9, (prep.n_cols,), generator=gen).float()
         if kind == "int" else torch.rand(prep.n_cols, generator=gen))
    x = x.to(cuda)
    reset_launch_counts()
    got = KERNELS["spmv_bell"](prep, x)
    torch.cuda.synchronize()
    from repro_torch.kernels import spmv_bell_plain

    assert torch.equal(got, spmv_bell_plain(prep, x))
    assert launch_counts()["spmv_bell"] == (1 if prep.n_rows else 0)


@pytest.mark.parametrize("lanes", [1, 2, 4])
@pytest.mark.parametrize("name", ["blocked", "overlapping-tiles",
                                  "ragged-edges"])
def test_bell_kernel_every_lane_count(cuda, name, lanes):
    """The kernel with 1, 2 or 4 lanes per row (4, 2 or 1 block rows per
    warp) against its plain version on real values, bit for bit."""
    prep = tkl.prepare_bell(BELL.from_csr(_bell_case(name, cuda)))
    prep = dataclasses.replace(prep, lanes=lanes, values=torch.rand(
        prep.values.shape, device=cuda) * (prep.values != 0))
    x = torch.rand(prep.n_cols, device=cuda)
    from repro_torch.kernels import spmv_bell_plain

    assert torch.equal(KERNELS["spmv_bell"](prep, x),
                       spmv_bell_plain(prep, x))


def _same_nan(got, want):
    nan = torch.isnan(want)
    return torch.equal(torch.isnan(got), nan) and \
        torch.equal(got[~nan], want[~nan])


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
@pytest.mark.parametrize("name", ["blocked", "empty-block-rows", "nnz0"])
def test_bell_kernel_non_finite_first_tile(cuda, name, bad):
    """Padded block rows add 0 * x[0:128]: NaN where the first tile is
    not finite, in the kernel as in the plain version (CPU)."""
    cpu = tkl.prepare_bell(BELL.from_csr(_bell_case(name, "cpu")))
    gpu = tkl.prepare_bell(BELL.from_csr(_bell_case(name, cuda)))
    x = torch.ones(cpu.n_cols)
    x[5] = bad
    want = tkl.spmv_bell_prepared(cpu, x)
    got = tkl.spmv_bell_prepared(gpu, x.to(cuda))
    torch.cuda.synchronize()
    assert torch.isnan(want).any()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("bad", [float("inf"), float("-inf"), float("nan")])
@pytest.mark.parametrize("where", ["dropped", "kept", "tile 0"])
def test_bell_kernel_non_finite_x_on_transposed_tiles(cuda, where, bad):
    """The PageRank operand's shape (8 kept columns per block): a
    non-finite x in a column that a block drops, in one it keeps, and in
    tile 0 (the padded rows' term) gives the plain version's NaN rows
    and values, and the plain version's NaN rows are those of the CPU."""
    rows, cols, _ = blocked_coo(2048, 24, 1)
    vals = np.random.default_rng(1).integers(1, 9, rows.size) \
        .astype(np.float32)
    csr = CSR.from_coo(cols, rows, vals, 2048, 2048, device="cpu")
    cpu = tkl.prepare_bell(BELL.from_csr(csr))
    gpu = tkl.prepare_bell(BELL.from_csr(csr.to(cuda)))
    from repro_torch.kernels.spmv_bell import column_mask

    kept = column_mask(cpu.masks)
    bc = cpu.block_cols.long()
    x = torch.from_numpy(np.random.default_rng(2).integers(
        -8, 9, 2048).astype(np.float32))
    for p in torch.nonzero(bc > 0).flatten()[:5].tolist():
        if where == "tile 0":
            assert bool(cpu.pad0.any())
            x[3] = bad
            break
        n = int(torch.nonzero(kept[p] == (where == "kept"))[0])
        x[int(bc[p]) * 128 + n] = bad
    want = tkl.spmv_bell_prepared(cpu, x)
    got = tkl.spmv_bell_prepared(gpu, x.to(cuda))
    from repro_torch.kernels import spmv_bell_plain

    plain = spmv_bell_plain(gpu, x.to(cuda))
    torch.cuda.synchronize()
    assert torch.isnan(want).any()
    assert _same_nan(got, plain) and _same_nan(got.cpu(), want)


def test_execute_many_replays_on_the_card(cuda):
    """C2: two `execute_many` calls on real-valued X over an R-MAT HYB
    plan and an FD padded-CSR plan are equal, each row equals `execute`
    of that row; the HYB kernel plan launches its batched segmented
    kernel once for the four rows, the padded-CSR plan its kernel once
    per row; the `use_pallas=False` plans (ordered sums) replay bit for
    bit too."""
    from repro_torch.core.generators import fd_matrix, rmat_matrix

    X = torch.rand(4, 1 << 14, device=cuda) * 2 - 1
    for gen, fmt, kern, n in ((rmat_matrix, "hyb", "spmm_csr_seg", 1),
                              (fd_matrix, "csr", "spmv_csr", 4)):
        m = gen(1 << 14, device=cuda)
        for use_pallas in (True, False):
            p = tcompile(m, format=fmt, use_pallas=use_pallas,
                         reorder="none", predictor="none", device=cuda)
            reset_launch_counts()
            Y = p.execute_many(X)
            assert launch_counts()[kern] == (n if use_pallas else 0)
            assert torch.equal(p.execute_many(X), Y)
            for k in range(4):
                assert torch.equal(p.execute(X[k]), Y[k])


def _card_batch(sr_name, k, n, seed, device):
    """Real-valued X with ±inf (and, under plus_times, -0.0) mixed in."""
    gen = torch.Generator().manual_seed(seed)
    X = torch.rand((k, n), generator=gen) * 2 - 1
    if sr_name in ("or_and", "max_times"):
        X = X.abs()
    pick = torch.rand((k, n), generator=gen)
    X[pick < 0.03] = float("inf")
    if sr_name != "max_times":
        X[(pick >= 0.03) & (pick < 0.05)] = float("-inf")
    X[(pick >= 0.05) & (pick < 0.07)] = -0.0
    return X.to(device)


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("k", [1, 2, 5, 64, 65])
@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("family", ["fd", "rmat", "single-dense-row"])
def test_batched_kernels_equal_per_row_kernels(cuda, family, sr_name, k):
    """`spmm_ell` and `spmm_csr_seg` (with and without a (k, n) base, in
    windows small enough that rows split) equal `spmv_ell` /
    `spmv_csr_seg` of each row bit for bit on real-valued X with ±inf
    and -0.0, launch once per call whatever k is, and replay bit for
    bit."""
    from repro_torch.kernels import (spmm_csr_seg, spmm_ell, spmv_csr_seg,
                                     spmv_ell)

    csr = port_int_operands(family, 1000, 3, sr_name, device=cuda)[0]
    sr = SEMIRINGS[sr_name]
    ell = tkl.prepare_ell(convert(csr, "ell", fill=sr.pad_value), sr)
    seg = tkl.prepare_csr_seg(csr, seg_len=64)
    X = _card_batch(sr_name, k, csr.n_cols, k, cuda)
    base = _card_batch(sr_name, k, csr.n_rows, k + 1, cuda)
    reset_launch_counts()
    Y = spmm_ell(ell.data, ell.idx, X, sr)
    assert launch_counts()["spmm_ell"] == 1
    assert torch.equal(_bits(Y), _bits(torch.stack(
        [spmv_ell(ell.data, ell.idx, X[c], sr) for c in range(k)])))
    assert torch.equal(_bits(spmm_ell(ell.data, ell.idx, X, sr)), _bits(Y))
    for b in (None, base):
        reset_launch_counts()
        Y = spmm_csr_seg(seg, X, sr, base=b)
        assert launch_counts()["spmm_csr_seg"] == 1
        want = torch.stack([spmv_csr_seg(seg, X[c], sr, base=None if b is
                                         None else b[c]) for c in range(k)])
        torch.cuda.synchronize()
        assert torch.equal(_bits(Y), _bits(want))
        assert torch.equal(_bits(spmm_csr_seg(seg, X, sr, base=b)), _bits(Y))


def _nan_batch(sr_name, k, n, seed, device):
    """`_card_batch` with NaN in about 2 % of the entries too."""
    X = _card_batch(sr_name, k, n, seed, device).cpu()
    pick = torch.rand((k, n), generator=torch.Generator().manual_seed(-seed))
    X[pick < 0.02] = float("nan")
    return X.to(device)


def _int_batch(sr_name, k, n, seed, device):
    """Integer values in the semiring's domain (min_plus: some +inf), on
    which the kernels and the plain versions agree exactly."""
    rng = np.random.default_rng(seed)
    lo = 0 if sr_name in ("or_and", "max_times") else -8
    hi = 2 if sr_name == "or_and" else 9
    X = rng.integers(lo, hi, (k, n)).astype(np.float32)
    if sr_name == "min_plus":
        X[rng.random((k, n)) < 0.05] = np.inf
    return torch.from_numpy(X).to(device)


REDESIGN_KS = [1, 3, 4, 5, 12, 16, 17, 33, 64, 65, 128]


@pytest.mark.parametrize("k", REDESIGN_KS)
@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("family", ["rmat", "single-dense-row"])
def test_redesigned_segmented_kernel_bit_for_bit(cuda, family, sr_name, k):
    """`spmm_csr_seg` at every group width (k <= 4 the columns kernel,
    then G = 2, 4, 8, 16 lanes a virtual thread, k > 64 in tiles of 64)
    over windows of 64 items, where the dense row is a hub spanning many
    windows: with ±inf, -0.0 and NaN in X and in the base, every row
    equals `spmv_csr_seg` of that row bit for bit, and a replay too; on
    integer values it equals the plain version exactly."""
    from repro_torch.kernels import (spmm_csr_seg, spmv_csr_seg,
                                     spmv_csr_seg_plain)

    csr = port_int_operands(family, 1000, 3, sr_name, device=cuda)[0]
    sr = SEMIRINGS[sr_name]
    seg = tkl.prepare_csr_seg(csr, seg_len=64)
    assert seg.split_rows.numel() > 0
    X = _nan_batch(sr_name, k, csr.n_cols, k, cuda)
    base = _nan_batch(sr_name, k, csr.n_rows, k + 1, cuda)
    for b in (None, base):
        reset_launch_counts()
        Y = spmm_csr_seg(seg, X, sr, base=b)
        assert launch_counts()["spmm_csr_seg"] == 1
        want = torch.stack([spmv_csr_seg(seg, X[c], sr, base=None if b is
                                         None else b[c]) for c in range(k)])
        torch.cuda.synchronize()
        assert torch.equal(_bits(Y), _bits(want))
        assert torch.equal(_bits(spmm_csr_seg(seg, X, sr, base=b)), _bits(Y))
    Xi = _int_batch(sr_name, k, csr.n_cols, k, cuda)
    Bi = _int_batch(sr_name, k, csr.n_rows, k + 1, cuda)
    assert torch.equal(spmm_csr_seg(seg, Xi, sr, base=Bi),
                       spmv_csr_seg_plain(seg, Xi, sr, base=Bi))


@pytest.mark.parametrize("k", REDESIGN_KS)
@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("family", ["fd", "rmat"])
def test_redesigned_ell_kernel_both_layouts_bit_for_bit(cuda, family,
                                                        sr_name, k):
    """`spmm_ell` on one slab forced through both gather layouts (X as it
    lies, and tiles of the interleaved copy's rows):
    equal bits, each row `spmv_ell` of that row with ±inf, -0.0 and NaN,
    the plain version exactly on integer values; the slab's own choice
    (`gather_layout`) is FD: direct, R-MAT: xt."""
    from repro_torch.kernels import spmm_ell, spmv_ell, spmv_ell_plain

    csr = port_int_operands(family, 1 << 12, 3, sr_name, device=cuda)[0]
    sr = SEMIRINGS[sr_name]
    ell = tkl.prepare_ell(convert(csr, "ell", fill=sr.pad_value), sr)
    assert gather_layout(ell.data, ell.idx, sr.pad_value) == \
        {"fd": "direct", "rmat": "xt"}[family]
    X = _nan_batch(sr_name, k, csr.n_cols, k, cuda)
    rows = torch.stack([spmv_ell(ell.data, ell.idx, X[c], sr)
                        for c in range(k)])
    got = {}
    for gather in ("direct", "xt"):
        reset_launch_counts()
        got[gather] = spmm_ell(ell.data, ell.idx, X, sr, _gather=gather)
        assert launch_counts()["spmm_ell"] == 1
        torch.cuda.synchronize()
        assert torch.equal(_bits(got[gather]), _bits(rows))
    assert torch.equal(_bits(tkl.spmm_ell_prepared(ell, X, sr)),
                       _bits(got["direct"]))
    Xi = _int_batch(sr_name, k, csr.n_cols, k, cuda)
    want = spmv_ell_plain(ell.data, ell.idx, Xi, sr)
    for gather in ("direct", "xt"):
        assert torch.equal(spmm_ell(ell.data, ell.idx, Xi, sr,
                                    _gather=gather), want)


@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
@pytest.mark.parametrize("fmt", ["ell", "hyb", "csr-seg"])
def test_batched_plans_match_plain_versions(cuda, fmt, sr_name):
    """A kernel plan's `execute_many` on integer-valued X equals the
    batched plain versions on the CPU exactly (one launch of each of its
    batched kernels), and each row equals `execute` bit for bit."""
    csr, x = port_int_operands("rmat", 1 << 12, 5, sr_name)
    X = np.stack([np.roll(x, s) for s in range(7)])
    kw = dict(format=fmt, semiring=sr_name, reorder="none",
              predictor="none")
    want = tcompile(csr, device="cpu", **kw).execute_many(X)
    p = tcompile(csr.to(cuda), device=cuda, **kw)
    reset_launch_counts()
    Y = p.execute_many(torch.from_numpy(X).to(cuda))
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {
        "ell": {"spmm_ell": 1}, "csr-seg": {"spmm_csr_seg": 1},
        "hyb": {"spmm_ell": 1, "spmm_csr_seg": 1}}[fmt]
    assert torch.equal(Y.cpu(), want)
    Xr = _card_batch(sr_name, 7, csr.n_cols, 9, cuda)
    Yr = p.execute_many(Xr)
    assert all(torch.equal(_bits(p.execute(Xr[c])), _bits(Yr[c]))
               for c in range(7))


def test_bell_and_reordered_plans_on_the_card(cuda):
    """A blocked graph's PageRank compiles to BELL and launches the BELL
    kernel once per iteration; a reordered DIA plan launches DIA and
    returns the unreordered result."""
    from repro_torch.reorder import rcm

    rows, cols, vals = blocked_coo(2048, 24, 1)
    adj = CSR.from_coo(rows, cols, vals, 2048, 2048, device=cuda)
    reset_launch_counts()
    res = tdrv.pagerank(adj, tol=1e-6, device=cuda)
    assert res.plan.format_name == "bell"
    assert launch_counts()["spmv_bell"] == res.n_iters
    band, x = port_int_operands("fd", 256, 3, "plus_times", device=cuda)
    p = np.random.default_rng(0).permutation(band.n_rows)
    scrambled = band.permute(p, p)
    plan = tcompile(scrambled, reorder=rcm(scrambled), device=cuda)
    xt = torch.from_numpy(x).to(cuda)
    assert torch.equal(plan.execute(xt), tcompile(
        scrambled, reorder="none", predictor="none",
        device=cuda).execute(xt))


# ---------------------------------------------------------------------------
# default-compiled plans: scored by the cost model, run on the card
# ---------------------------------------------------------------------------

PLAN_KERNELS = {"dia": ("spmv_dia",), "csr": ("spmv_csr",),
                "hyb": ("spmv_ell", "spmv_csr_seg")}


@pytest.mark.parametrize("family", ["fd", "rmat", "scrambled"])
def test_default_compiled_plans_run_their_kernels(cuda, family):
    """`compile(m)` with the reference's defaults at 2^16 (cost-model
    scoring of 'none' against 'rcm'): the card plan decides as its CPU
    twin does, launches its format's kernels once per execute and, on
    integer values, equals its `use_pallas=False` twin and the CPU plan
    bit for bit; its address trace is the CPU plan's."""
    from repro_torch.core.cache_model import SANDY_BRIDGE
    from repro_torch.core.generators import (banded_matrix, fd_matrix,
                                             rmat_matrix)

    n = 1 << 16
    if family == "scrambled":
        perm = np.random.default_rng(0).permutation(n)
        m = banded_matrix(n, 8, device=cuda).permute(perm, perm)
    else:
        m = (fd_matrix if family == "fd" else rmat_matrix)(n, device=cuda)
    gen = torch.Generator().manual_seed(5)
    m = dataclasses.replace(m, data=torch.randint(
        1, 9, (m.nnz,), generator=gen).float().to(cuda))
    p = tcompile(m, device=cuda)
    cpu = tcompile(m.to("cpu"), device="cpu")
    assert p.compile_stats["scoring"] == "model"
    assert (p.chosen, p.format_name, p.predicted) == \
        (cpu.chosen, cpu.format_name, cpu.predicted)
    x = torch.randint(-8, 9, (n,), generator=gen).float()
    reset_launch_counts()
    y = p.execute(x.to(cuda))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert {k for k, v in counts.items() if v} == \
        set(PLAN_KERNELS[p.format_name])
    assert all(counts[k] == 1 for k in PLAN_KERNELS[p.format_name])
    plain = dataclasses.replace(p, prep=None, use_pallas=False)
    assert torch.equal(y, plain.execute(x.to(cuda)))
    assert torch.equal(y.cpu(), cpu.execute(x))
    assert np.array_equal(p.address_trace(SANDY_BRIDGE),
                          cpu.address_trace(SANDY_BRIDGE))


# ---------------------------------------------------------------------------
# flash and paged attention
# ---------------------------------------------------------------------------

def _randn(shape, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)


def _close(got, want, dtype):
    """float32 within rtol 1e-4 / atol 1e-5 (summation order); bfloat16
    within one bfloat16 ulp, taken at |value| >= 2^-8 (each side rounds
    its float32 result once)."""
    if dtype == torch.float32:
        return bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5))
    return within_bf16_ulp(got, want)


FLASH_GPU_CASES = [
    # bh, sq, skv, d, causal, window, bq, bk[, q scale]
    (4, 256, 256, 128, True, None, 128, 128),
    (4, 512, 512, 64, True, 100, 128, 128),
    (3, 256, 512, 128, False, None, 128, 128),
    (2, 256, 128, 64, False, 64, 128, 128),     # rows 191-255: mean of v
    (2, 256, 256, 64, False, 40, 32, 64),       # a finer function grid
    (2, 200, 100, 128, True, None, 200, 100),   # ragged CUDA tiles
    # 3 x 3 tiles of 128: absent, all-visible and mixed tiles
    (2, 384, 384, 128, True, None, 128, 128),
    (2, 320, 192, 64, True, 96, 64, 64),        # lengths off the tile
    (2, 256, 256, 64, True, 1, 128, 128),       # window 1: the diagonal
    (3, 128, 16, 128, True, None, 128, 128),    # skv below one tile
    # a peaked softmax: q scaled by 8, so lo and the exp range matter
    (2, 256, 256, 128, True, None, 128, 128, 8.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_GPU_CASES)
def test_flash_kernel_matches_its_plain_version(cuda, case, dtype):
    from repro_torch.kernels import flash_attention_plain

    bh, sq, skv, d, causal, window, bq, bk, *q_scale = case
    q = (_randn((bh, sq, d), torch.float32, cuda, 0)
         * (q_scale[0] if q_scale else 1.0)).to(dtype)
    k = _randn((bh, skv, d), dtype, cuda, 1)
    v = _randn((bh, skv, d), dtype, cuda, 2)
    reset_launch_counts()
    got = KERNELS["flash_attention"](q, k, v, causal, window, bq, bk)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, causal, window, bq, bk)
    assert got.dtype == dtype and _close(got, want, dtype)
    again = KERNELS["flash_attention"](q, k, v, causal, window, bq, bk)
    assert torch.equal(got, again)                 # replays: same bits
    assert launch_counts()["flash_attention"] == 2


def test_flash_masked_rows_are_the_mean_of_v_on_the_card(cuda):
    k = _randn((2, 128, 64), torch.float32, cuda, 1)
    v = _randn((2, 128, 64), torch.float32, cuda, 2)
    q = _randn((2, 256, 64), torch.float32, cuda, 0)
    got = KERNELS["flash_attention"](q, k, v, causal=False, window=64)
    torch.testing.assert_close(
        got[:, 191:], v.mean(dim=1, keepdim=True).expand(2, 65, 64),
        rtol=1e-4, atol=1e-5)


F32_TC_MASKS = [(True, None), (True, 48), (False, None), (False, 40)]


@pytest.mark.parametrize("causal,window", F32_TC_MASKS)
@pytest.mark.parametrize("d", [64, 128])
def test_flash_f32_tensor_core_kernel_off_its_tiles(cuda, d, causal, window):
    """The 3xTF32 kernel with sq = 200 (not a multiple of its 64 rows) and
    skv = 136 (not a multiple of its 32 keys, so TMA zero-fills the last
    tile past the split Vᵀ), on a (40, 8) function grid: within rtol 1e-4
    / atol 1e-5 of the plain version, replays bit for bit."""
    from repro_torch.kernels import flash_attention_plain

    q = _randn((3, 200, d), torch.float32, cuda, 0)
    k = _randn((3, 136, d), torch.float32, cuda, 1)
    v = _randn((3, 136, d), torch.float32, cuda, 2)
    got = KERNELS["flash_attention"](q, k, v, causal, window, 40, 8)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal, window, 40, 8)
    assert _close(got, want, torch.float32)
    assert torch.equal(got, KERNELS["flash_attention"](q, k, v, causal,
                                                       window, 40, 8))


def test_flash_f32_masked_rows_are_the_mean_of_v_at_d128(cuda):
    k = _randn((2, 128, 128), torch.float32, cuda, 1)
    v = _randn((2, 128, 128), torch.float32, cuda, 2)
    q = _randn((2, 256, 128), torch.float32, cuda, 0)
    got = KERNELS["flash_attention"](q, k, v, causal=False, window=64)
    torch.testing.assert_close(
        got[:, 191:], v.mean(dim=1, keepdim=True).expand(2, 65, 128),
        rtol=1e-4, atol=1e-5)


def _paged_case(h, kvh, hd, dtype, device, lengths, n_blocks=64, block=16,
                max_blocks=8, seed=0):
    rng = np.random.default_rng(seed)
    bsz = len(lengths)
    perm = rng.permutation(n_blocks)[: bsz * max_blocks]
    tables = torch.from_numpy(perm.reshape(bsz, max_blocks).astype(np.int32))
    return (_randn((bsz, h, hd), dtype, device, seed),
            _randn((n_blocks, block, kvh, hd), dtype, device, seed + 1),
            _randn((n_blocks, block, kvh, hd), dtype, device, seed + 2),
            tables.to(device),
            torch.tensor(lengths, dtype=torch.int32, device=device))


PAGED_GPU_CASES = [
    # h, kvh, hd, lengths
    (32, 8, 128, [1, 17, 128, 100, 0, 64]),    # Granite-8B's heads
    (8, 2, 64, [5, 33, 128]),
    (4, 4, 32, [0, 0, 7]),
    (16, 1, 128, [128, 65]),                   # 16 query heads per KV head
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PAGED_GPU_CASES)
def test_paged_kernel_matches_its_plain_version(cuda, case, dtype):
    from repro_torch.kernels import paged_attention_plain

    h, kvh, hd, lengths = case
    args = _paged_case(h, kvh, hd, dtype, cuda, lengths)
    reset_launch_counts()
    got = KERNELS["paged_attention"](*args)
    torch.cuda.synchronize()
    assert launch_counts()["paged_attention"] == 1
    want = paged_attention_plain(*args)
    assert got.dtype == dtype and _close(got, want, dtype)
    zero = [i for i, n in enumerate(lengths) if n == 0]
    assert torch.equal(got[zero], torch.zeros_like(got[zero]))
    assert torch.equal(got, KERNELS["paged_attention"](*args))
    assert launch_counts()["paged_attention"] == 2


def test_paged_kernel_never_reads_stale_table_entries(cuda):
    """Entries past ceil(length / block) hold other blocks or ids outside
    the pool: the output is the same bits.  An entry inside that lies
    outside the pool gives NaN for its sequence only."""
    q, kp, vp, tables, lengths = _paged_case(32, 8, 128, torch.bfloat16,
                                             cuda, [20, 1, 128, 0])
    base = KERNELS["paged_attention"](q, kp, vp, tables, lengths)
    stale = tables.clone()
    stale[0, 2:] = 3
    stale[1, 1:] = 2 ** 30
    stale[3, :] = -7
    assert torch.equal(KERNELS["paged_attention"](q, kp, vp, stale, lengths),
                       base)
    stale[0, 1] = 64                              # n_blocks: outside
    got = KERNELS["paged_attention"](q, kp, vp, stale, lengths)
    torch.cuda.synchronize()
    assert torch.isnan(got[0].float()).all()
    assert torch.equal(got[1:], base[1:])


# the smoke's width: Granite-8B's 32/8 heads of 128, 16-token blocks, and
# the wrapper's 512-token spans (8 a sequence at 256 blocks)
SPAN_LENGTHS = {
    "span edges": [1, 511, 512, 513, 1024, 1025, 0, 2047],
    "one long": [4096, 3, 17, 200, 1, 40],
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(SPAN_LENGTHS))
def test_paged_split_walk_at_the_smokes_width(cuda, name, dtype):
    from repro_torch.kernels import paged_attention_plain

    lengths = SPAN_LENGTHS[name]
    args = _paged_case(32, 8, 128, dtype, cuda, lengths,
                       n_blocks=256 * len(lengths), max_blocks=256)
    got = KERNELS["paged_attention"](*args)
    torch.cuda.synchronize()
    assert _close(got, paged_attention_plain(*args), dtype)
    assert torch.equal(got, KERNELS["paged_attention"](*args))
    zero = [i for i, n in enumerate(lengths) if n == 0]
    assert torch.equal(got[zero], torch.zeros_like(got[zero]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_bad_entry_in_the_last_span_only(cuda, dtype):
    """An entry outside the pool that only the last of a sequence's spans
    walks makes the whole sequence NaN; the others are untouched."""
    lengths = [1500, 1500, 700]
    args = list(_paged_case(32, 8, 128, dtype, cuda, lengths,
                            n_blocks=768, max_blocks=256))
    base = KERNELS["paged_attention"](*args)
    tables = args[3].clone()
    tables[0, 1499 // 16] = 768                   # span 2 of 0..2
    args[3] = tables
    got = KERNELS["paged_attention"](*args)
    torch.cuda.synchronize()
    assert torch.isnan(got[0].float()).all()
    assert torch.equal(got[1:], base[1:])
    assert torch.equal(got.isnan(), KERNELS["paged_attention"](*args).isnan())


@pytest.mark.parametrize("what", ["dtype", "head_dim", "group", "int64"])
def test_attention_kernels_refuse_what_they_do_not_take(cuda, what):
    """Unsupported inputs raise on the card; nothing falls back."""
    dt = torch.float16 if what == "dtype" else torch.float32
    d = 96 if what == "head_dim" else 64
    q = _randn((2, 128, d), dt, cuda, 0)
    reset_launch_counts()
    if what in ("dtype", "head_dim"):
        with pytest.raises(ValueError):
            KERNELS["flash_attention"](q, q, q)
    h, kvh = (32, 1) if what == "group" else (8, 2)
    args = list(_paged_case(h, kvh, d, dt, cuda, [5, 9]))
    if what == "int64":
        args[3] = args[3].long()
    with pytest.raises(ValueError):
        KERNELS["paged_attention"](*args)
    assert sum(launch_counts().values()) == 0


def test_ops_and_pool_on_the_card(cuda):
    """`ops` attention through a pool written with `write_token` from an
    allocator's tables, against the plain versions; one launch each."""
    from repro_torch.kernels import (flash_attention_plain, ops,
                                     paged_attention_plain)
    from repro_torch.serve import (BlockAllocator, PoolConfig, gather_kv,
                                   init_pool, write_token)

    cfg = PoolConfig(n_blocks=64, block_size=16, max_blocks_per_seq=8)
    al = BlockAllocator(cfg)
    lengths = [40, 7, 100]
    for sid, n in enumerate(lengths):
        al.admit(sid, n)
    pool = init_pool(cfg, 8, 128, 1, dtype=torch.bfloat16, device=cuda)
    sid, pos = np.repeat(np.arange(3), lengths), np.concatenate(
        [np.arange(n) for n in lengths])
    blk = np.array([al.tables[s][p // 16] for s, p in zip(sid, pos)])
    kn = _randn((len(sid), 8, 128), torch.float32, cuda, 3)
    vn = _randn((len(sid), 8, 128), torch.float32, cuda, 4)
    write_token(pool, 0, torch.from_numpy(blk), torch.from_numpy(pos % 16),
                kn, vn)
    tables = torch.from_numpy(np.stack([al.table_array(s) for s in
                                        range(3)])).to(cuda)
    lens = torch.tensor(lengths, device=cuda)
    k_seq, _ = gather_kv(pool, 0, tables)
    assert torch.equal(k_seq[0, :40].float(), kn[:40].bfloat16().float())
    q = _randn((3, 32, 128), torch.bfloat16, cuda, 5)
    reset_launch_counts()
    got = ops.paged_attention(q, pool["k"][0], pool["v"][0], tables, lens)
    qf = _randn((1, 4, 256, 128), torch.bfloat16, cuda, 6)
    fl = ops.flash_attention(qf, qf, qf, causal=True, window=64)
    assert launch_counts()["paged_attention"] == 1
    assert launch_counts()["flash_attention"] == 1
    assert within_bf16_ulp(got, paged_attention_plain(
        q, pool["k"][0], pool["v"][0], tables.int(), lens.int()))
    assert within_bf16_ulp(fl[0], flash_attention_plain(
        qf[0], qf[0], qf[0], True, 64))


# ---------------------------------------------------------------------------
# streaming: overlaid plans and the serving engine on the card
# ---------------------------------------------------------------------------

def _card_delta(csr, sr_name, seed):
    """Integer inserts in the semiring's domain and, under plus_times,
    deletes of stored edges."""
    from repro_torch.core.delta import EdgeDelta

    rng = np.random.default_rng(seed)
    hi = 1 if sr_name == "or_and" else 8
    ins = [(r, c, float(rng.integers(1, hi + 1)))
           for r, c in fresh_coords(csr, 40, rng)]
    rows, cols, _ = coo_of(csr)
    dels = [(int(rows[p]), int(cols[p])) for p in
            rng.choice(rows.size, 20, replace=False)] \
        if sr_name == "plus_times" else []
    return EdgeDelta.from_updates(csr, inserts=ins, deletes=dels)


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "or_and"])
@pytest.mark.parametrize("fmt", ["hyb", "csr"])
def test_overlaid_plan_equals_its_materialization_on_the_card(
        cuda, fmt, sr_name):
    """An overlaid HYB or padded-CSR plan at 2^12 answers as a fresh
    compile of its materialised matrix: bit for bit on integer-valued
    plus-times (deletes included), exactly under min_plus (+inf in x)
    and or_and; the delta pass runs on the card, its `execute_many`
    replays bit for bit with rows equal to `execute`, and the CPU's
    overlay gives the same numbers."""
    from repro_torch.plan import overlay

    csr, x = port_int_operands("rmat", 1 << 12, 5, sr_name, device=cuda)
    if sr_name == "min_plus":
        x[::97] = np.inf
    delta = _card_delta(csr, sr_name, 6)
    kw = dict(format=fmt, semiring=sr_name, reorder="none", predictor="none")
    ov = overlay(tcompile(csr, device=cuda, **kw), delta,
                 staleness_budget=1.0)
    fresh = tcompile(ov.materialize(), device=cuda, **kw)
    assert ov.materialize().device == csr.device
    xt = torch.from_numpy(x).to(cuda)
    reset_launch_counts()
    y = ov.execute(xt)
    torch.cuda.synchronize()
    assert sum(launch_counts().values()) >= 1
    assert y.device == xt.device
    assert torch.equal(y, fresh.execute(xt))
    X = torch.stack([xt, xt.roll(1), xt.flip(0), xt.roll(5)])
    Y = ov.execute_many(X)
    assert torch.equal(ov.execute_many(X), Y)
    assert all(torch.equal(ov.execute(X[k]), Y[k]) for k in range(4))
    cpu = overlay(tcompile(csr.to("cpu"), device="cpu", **kw), delta,
                  staleness_budget=1.0)
    assert torch.equal(cpu.execute(torch.from_numpy(x)), y.cpu())


def _card_trace(cuda, cache):
    """An engine trace on the card with two R-MAT mutations: an
    overlay for every lineage, then deletes (re-plans and a swap for
    the ⊕-only semirings)."""
    from repro_torch.core.generators import fd_matrix, rmat_matrix
    from repro_torch.serve_graph import (AnalyticRequest, GraphEngine,
                                         GraphEngineConfig, GraphMutation)

    g = {"fd": fd_matrix(1 << 12, device=cuda),
         "rmat": rmat_matrix(1 << 12, device=cuda)}
    eng = GraphEngine(GraphEngineConfig(n_lanes=16, compiles_per_step=None,
                                        device=cuda), plan_cache=cache)
    for gid, adj in g.items():
        eng.register_graph(gid, adj)
    for i, (gid, name, src) in enumerate([
            ("rmat", "pagerank", (1, 2)), ("rmat", "sssp", (0, 3)),
            ("rmat", "bfs", (4,)), ("rmat", "connected_components", ()),
            ("fd", "bfs", (0, 9, 17)), ("fd", "pagerank", ())]):
        eng.submit(AnalyticRequest(i, gid, name, sources=src,
                                   params={"tol": 1e-5}
                                   if name == "pagerank" else {}))
    rng = np.random.default_rng(0)
    for _ in range(2):
        eng.step()
    ins = tuple((r, c, 2.0) for r, c in fresh_coords(g["rmat"], 8, rng))
    eng.submit(GraphMutation(100, "rmat", inserts=ins))
    for _ in range(2):
        eng.step()
    rows, cols, _ = coo_of(eng.graphs["rmat"])
    eng.submit(GraphMutation(101, "rmat", deletes=tuple(
        (int(rows[p]), int(cols[p])) for p in rng.choice(rows.size, 4,
                                                         replace=False))))
    out = eng.run()
    return (eng.scheduler.log,
            {m: r.actions for m, r in eng.mutation_results.items()},
            {k: v for k, v in eng.plan_cache.stats().items()
             if k != "compile_s"},
            {r: (v.values.tobytes(), v.n_iters) for r, v in out.items()})


def test_engine_trace_with_mutations_replays_on_the_card(cuda):
    """Two runs of one trace, each with a fresh plan cache: the same
    schedule, mutation actions and counters, bit-identical values; the
    coalesced SpMMs ran through the kernels."""
    from repro_torch.plan import PlanCache

    reset_launch_counts()
    a = _card_trace(cuda, PlanCache())
    counts = launch_counts()
    b = _card_trace(cuda, PlanCache())
    assert a == b
    assert a[1][100] == dict.fromkeys(
        ("pagerank", "sssp", "bfs", "connected_components"), "overlay")
    assert a[1][101]["sssp"] == "replan" and \
        a[1][101]["pagerank"] == "overlay"
    assert counts["spmm_csr_seg"] > 0 and counts["spmm_ell"] > 0


@pytest.mark.parametrize("family", ["fd", "rmat"])
@pytest.mark.parametrize("balanced", [False, True])
def test_sharded_plan_on_the_card(cuda, family, balanced):
    """Four slabs on one card: one `spmv_ell` launch each, bit-identical
    to the CSR plan on integer values, and through a checkpoint."""
    import tempfile

    from repro_torch import plan as tplan
    from repro_torch.core.partition import rowblock_balanced
    from repro_torch.distributed import row_mesh

    csr, x = port_int_operands(family, 4096, 3, "plus_times", device=cuda)
    x = torch.as_tensor(x, device=cuda)
    mesh = row_mesh([str(cuda)] * 4)
    part = rowblock_balanced(csr, 4) if balanced else None
    p = tplan.compile(csr, mesh=mesh, partition=part, reorder="none",
                      predictor="none")
    want = tplan.compile(csr, format="csr", reorder="none",
                         predictor="none", device=cuda).execute(x)
    reset_launch_counts()
    y = p.execute(x)
    assert launch_counts()["spmv_ell"] == 4 and torch.equal(y, want)
    with tempfile.TemporaryDirectory() as d:
        tplan.save_plan(p, d)
        back, _ = tplan.load_plan(d, mesh=mesh)
        assert torch.equal(back.execute(x), want)


def test_graph_cell_runs_through_the_kernels(cuda):
    """A sweep's graph cell on the card: one launch an iteration, and
    BFS points equal to the CPU's bytes (or_and is exact)."""
    from repro_torch.telemetry import runner, sweep

    info = {}
    cells = runner.graph_cells((8,), ("fd", "rmat"), ("bfs",))
    pts = runner.execute_cells(cells, runner.SweepConfig(device="cuda"),
                               cell_info=info)
    cpu = runner.execute_cells(cells, runner.SweepConfig(device="cpu"))
    assert [runner.encode_point(p) for p in pts] == \
        [runner.encode_point(p) for p in cpu]
    got = {k: v["launches"] for k, v in info.items()}
    assert got["graph|fd|8|none|-|1|-|-|bfs"]["spmv_ell"] == pts[0].n_iters
    assert got["graph|rmat|8|none|-|1|-|-|bfs"]["spmv_csr_seg"] == \
        pts[1].n_iters
    assert isinstance(pts[0], sweep.GraphPoint)


# ---------------------------------------------------------------------------
# the LM serving path: prefill on the flash kernel, decode on the paged one
# ---------------------------------------------------------------------------

def _card_lm_config(dtype):
    """Granite's family at a small width with the kernels' head size:
    2 layers, 4 query heads, 2 KV heads, head_dim 128."""
    from repro_torch.configs import CONFIGS

    return dataclasses.replace(CONFIGS["granite-8b"].reduced(), n_heads=4,
                               n_kv_heads=2, head_dim=128, dtype=dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_kernel_path_matches_the_plain_path(cuda, dtype):
    """Prefill (the flash kernel) and teacher-forced decode steps (the
    paged kernel over the dense cache) against the plain attention on
    the same card, within the reference's cache bar (bfloat16) or rtol
    1e-4 / atol 1e-5 (float32); each kernel launched once a layer."""
    from repro_torch.models import registry, transformer

    cfg = _card_lm_config(dtype)
    api = registry.get_model(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(2), cuda)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (3, 40)).astype(np.int32)).to(cuda)
    tol = dict(rtol=0.08, atol=0.08) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for kern in (True, False):
        reset_launch_counts()
        logits, cache = api.prefill(params, {"tokens": toks[:, :32]}, 64,
                                    use_kernels=kern)
        out = [logits[:, -1]]
        for t in range(32, 40):
            step, cache = api.decode_step(params, cache, toks[:, t:t + 1],
                                          use_kernels=kern)
            out.append(step[:, 0])
        torch.cuda.synchronize()
        runs[kern] = (torch.stack(out, 1).float(), launch_counts())
        assert transformer.init_cache(cfg, 1, 8, cuda)["pos"].is_cuda
    got, counts = runs[True]
    want, plain_counts = runs[False]
    assert torch.isfinite(got).all()
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["paged_attention"] == 8 * cfg.n_layers
    assert sum(plain_counts.values()) == 0
    torch.testing.assert_close(got, want, **tol)


def test_lm_engine_idle_slot_past_max_context(cuda):
    """A pool that admits one request at a time keeps two slots idle
    while four requests run, so their pos passes max_context: the kernel
    path's engine finishes with no device assert and no NaN, and its
    greedy tokens (float32) equal the plain path's."""
    from repro_torch.models import registry
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = _card_lm_config("float32")
    params = registry.get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(4), cuda)
    rng = np.random.default_rng(5)
    lengths = [(9, 6), (8, 7), (10, 5), (9, 6)]
    ecfg = EngineConfig(max_batch=3, max_context=16, block_size=4,
                        pool_blocks=4)
    torch.backends.cuda.matmul.allow_tf32 = False
    prompts = [rng.integers(1, cfg.vocab, p).tolist() for p, _ in lengths]
    out = {}
    for kern in (True, False):
        eng = Engine(cfg, params, ecfg, use_kernels=kern)
        reset_launch_counts()
        out[kern] = eng.run([Request(req_id=i, prompt=list(p),
                                     max_new_tokens=m)
                             for i, (p, (_, m)) in enumerate(
                                 zip(prompts, lengths))])
        torch.cuda.synchronize()
        assert max(eng.cache["pos"].tolist()) > ecfg.max_context
        for layer in eng.cache["layers"]:
            assert torch.isfinite(layer["kv"]["k"]).all()
        if kern:
            assert launch_counts()["paged_attention"] > 0
            logits = eng.decode(torch.zeros((3, 1), dtype=torch.int32,
                                            device=cuda))
            torch.cuda.synchronize()
            assert torch.isfinite(logits).all()
    assert out[True] == out[False]
    assert {r: len(v) for r, v in out[True].items()} == \
        {i: m for i, (_, m) in enumerate(lengths)}


# ---------------------------------------------------------------------------
# the training path: autograd over the plain attention, AdamW, launcher
# ---------------------------------------------------------------------------

def _train_setup(device):
    """Reduced stablelm in float32: parameters drawn on the CPU (so every
    device starts from the same ones), moved to `device`, and a fresh
    AdamW state there."""
    from repro_torch.configs import CONFIGS
    from repro_torch.models import registry
    from repro_torch.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.loop import TrainConfig, init_train_state
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(CONFIGS["stablelm-1.6b"].reduced(),
                              dtype="float32")
    api = registry.get_model(cfg)
    tc = TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                               total_steps=100),
                     remat="none")
    params, _ = init_train_state(api, tc, torch.Generator().manual_seed(3),
                                 "cpu")
    params = tree_map(lambda t: t.to(device), params)
    return cfg, api, tc, params, make_optimizer(tc.optimizer)[0](params)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """float32, TF32 off: three steps on the card and on the CPU from the
    same state and batches; loss within rtol 1e-5, grad_norm 1e-4, the
    gradients before each step within 1e-4 of each leaf's max |g|.
    Params after the first step within rtol 1e-4 / atol 1e-6, after three
    within rtol 1e-4 / atol 1e-5, outside the elements whose first update
    (at the first step with a nonzero gradient there on either device)
    the two devices' gradient difference can flip: |g_cpu| < max(100
    |g_card - g_cpu|, 1e-6).  AdamW's first step there is +-lr by a sign that
    float32 rounding (and the card's index backward, which adds in no
    fixed order) decides.  The looser bar after three steps: AdamW scales
    each element's step by its own gradient history, so an element whose
    gradients are small carries their larger relative error into its
    step (measured on the H100: 4.4e-6 at one of 65,452 elements)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.loop import loss_and_grads, make_train_step
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    runs = []
    for dev in (torch.device("cpu"), cuda):
        cfg, api, tc, params, opt = _train_setup(dev)
        pipe = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                      global_batch=4, seed=5), device=dev)
        step = make_train_step(api, tc)
        grads, metrics, after = [], [], []
        for i in range(3):
            _, g = loss_and_grads(api, "none")(params, pipe.batch_at(i))
            grads.append([t.cpu() for t in leaves(g)])
            params, opt, m = step(params, opt, pipe.batch_at(i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            after.append([p.to("cpu", copy=True) for p in leaves(params)])
        runs.append((grads, metrics, after))
    (g_cpu, m_cpu, p_cpu), (g_dev, m_dev, p_dev) = runs
    for (lc, nc), (ld, nd) in zip(m_cpu, m_dev):
        np.testing.assert_allclose(ld, lc, rtol=1e-5)
        np.testing.assert_allclose(nd, nc, rtol=1e-4)
    noise = [torch.zeros_like(g, dtype=torch.bool) for g in g_cpu[0]]
    seen = [torch.zeros_like(g, dtype=torch.bool) for g in g_cpu[0]]
    masks = []
    for gs_dev, gs_cpu in zip(g_dev, g_cpu):
        for i, (gd, gc) in enumerate(zip(gs_dev, gs_cpu)):
            diff = (gd - gc).abs()
            assert diff.max() <= 1e-4 * gc.abs().max()
            nonzero = (gc != 0) | (gd != 0)
            flip = nonzero & (gc.abs() < torch.clamp(100 * diff, min=1e-6))
            noise[i] = noise[i] | (flip & ~seen[i])
            seen[i] = seen[i] | nonzero
        masks.append(list(noise))
    for after, mask, atol in ((0, masks[0], 1e-6), (-1, masks[-1], 1e-5)):
        for pd, pc, skip in zip(p_dev[after], p_cpu[after], mask):
            torch.testing.assert_close(pd[~skip], pc[~skip], rtol=1e-4,
                                       atol=atol)


def test_train_attention_kernels_refuse_grad_on_the_card(cuda):
    """A gradient through the flash or paged kernel raises on CUDA
    tensors (their outputs would carry no autograd history); without
    grad the kernels launch as before."""
    from repro_torch.kernels import ops
    from repro_torch.models import convert
    from repro_torch.tree import tree_map

    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(1, 2, 128, 64, generator=g, device=cuda)
               for _ in range(3))
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
    pool = torch.randn(4, 16, 2, 64, generator=g, device=cuda)
    qd = torch.randn(2, 4, 64, generator=g, device=cuda)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([20, 32], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.paged_attention(qd.requires_grad_(), pool, pool, tables, lengths)
    assert launch_counts()["flash_attention"] == 0
    assert launch_counts()["paged_attention"] == 0
    with torch.no_grad():
        assert torch.isfinite(ops.flash_attention(q, k, v)).all()
        assert torch.isfinite(
            ops.paged_attention(qd, pool, pool, tables, lengths)).all()
    assert launch_counts()["flash_attention"] == 1
    assert launch_counts()["paged_attention"] == 1
    cfg, api, _, params, _ = _train_setup(cuda)
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    toks = torch.zeros((2, 16), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        api.loss_fn(convert.params_from_reference(live, cfg, cuda),
                    {"tokens": toks, "labels": toks}, use_kernels=True)


def test_train_launcher_crash_restart_on_the_card(cuda, tmp_path):
    """The launcher on the card, clean and with a crash at step 7: the
    same last step, final losses within rel 1e-5."""
    from repro_torch.launch import train as launch_train

    args = ["--arch", "stablelm-1.6b", "--reduced", "--steps", "12",
            "--batch", "2", "--seq", "16", "--ckpt-every", "4",
            "--log-every", "100", "--device", "cuda"]
    clean = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    crashed = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                        "--fail-at-step", "7"])
    assert clean[-1][0] == crashed[-1][0] == 11
    assert crashed[-1][1] == pytest.approx(clean[-1][1], rel=1e-5)


# ---------------------------------------------------------------------------
# the MoE, Mamba-hybrid and RWKV families on the card
# ---------------------------------------------------------------------------

def _card_hybrid_config(arch, dtype):
    """A family's reduced config with the kernels' head size where it has
    attention (4 query heads, 2 KV heads, head_dim 128); Jamba keeps one
    period (8 layers)."""
    from repro_torch.configs import CONFIGS

    cfg = CONFIGS[arch].reduced()
    if arch == "jamba-v0.1-52b":
        cfg = dataclasses.replace(cfg, n_layers=8)
    if arch != "rwkv6-3b":
        cfg = dataclasses.replace(cfg, n_heads=4, n_kv_heads=2,
                                  head_dim=128)
    return dataclasses.replace(cfg, dtype=dtype)


def _bits(t):
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) \
        if t.is_floating_point() else t


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hybrid_kernel_path_matches_the_plain_path(cuda, dtype):
    """Jamba's period on the card: a 256-token prompt (the Mamba scan
    over two chunks, the flash kernel in the attention layer, the MoE
    layers) and teacher-forced decode steps (the paged kernel) against
    the plain attention on the same card, within the reference's cache
    bar (bfloat16) or rtol 1e-4 / atol 1e-5 (float32); flash once a
    prompt and paged once a step in the one attention layer."""
    from repro_torch.models import registry

    cfg = _card_hybrid_config("jamba-v0.1-52b", dtype)
    api = registry.get_model(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(6), cuda)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (2, 262)).astype(np.int32)).to(cuda)
    tol = dict(rtol=0.08, atol=0.08) if dtype == "bfloat16" else \
        dict(rtol=1e-4, atol=1e-5)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for kern in (True, False):
        reset_launch_counts()
        logits, cache = api.prefill(params, {"tokens": toks[:, :256]}, 272,
                                    use_kernels=kern)
        out = [logits[:, -1]]
        for t in range(256, 262):
            step, cache = api.decode_step(params, cache, toks[:, t:t + 1],
                                          use_kernels=kern)
            out.append(step[:, 0])
        torch.cuda.synchronize()
        runs[kern] = (torch.stack(out, 1).float(), launch_counts())
    got, counts = runs[True]
    want, plain_counts = runs[False]
    assert torch.isfinite(got).all()
    assert counts["flash_attention"] == 1
    assert counts["paged_attention"] == 6
    assert sum(plain_counts.values()) == 0
    torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "arctic-480b",
                                  "kimi-k2-1t-a32b", "rwkv6-3b"])
def test_hybrid_family_on_the_card_matches_the_cpu(cuda, arch):
    """float32, TF32 off, the same parameters: the plain path's forward,
    a 256-token prompt (RWKV's chunked wkv, two Mamba chunks) and four
    decode steps on the card against the CPU: logits within rtol 1e-4 /
    atol 1e-4, the MoE aux loss within rtol 1e-5."""
    from repro_torch.models import registry, transformer
    from repro_torch.tree import tree_map

    cfg = _card_hybrid_config(arch, "float32")
    api = registry.get_model(cfg)
    p_cpu = api.init(torch.Generator().manual_seed(8), "cpu")
    p_dev = tree_map(lambda t: t.to(cuda), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 260)).astype(np.int32))
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    for where, p in (("cpu", p_cpu), ("card", p_dev)):
        d = cuda if where == "card" else torch.device("cpu")
        x, _, aux = transformer.forward(p, cfg, tokens=toks[:, :32].to(d),
                                        use_kernels=False)
        logits, cache = api.prefill(p, {"tokens": toks[:, :256].to(d)}, 272,
                                    use_kernels=False)
        out = [logits[:, -1]]
        for t in range(256, 260):
            step, cache = api.decode_step(p, cache, toks[:, t:t + 1].to(d),
                                          use_kernels=False)
            out.append(step[:, 0])
        res[where] = ((x @ transformer.head_matrix(p, cfg)).float().cpu(),
                      torch.stack(out, 1).float().cpu(), float(aux))
    for a, b in zip(res["card"][:2], res["cpu"][:2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert res["card"][2] == pytest.approx(res["cpu"][2], rel=1e-5)


def test_hybrid_routing_on_the_card_equals_the_cpu(cuda):
    """`moe.route` on the same float32 probabilities, ties and a capacity
    of 1 included: top_e, the order, keep, slots and tokens equal."""
    from repro_torch.models import moe

    rng = np.random.default_rng(10)
    cases = [(torch.softmax(torch.from_numpy(rng.normal(
        size=(512, 16)).astype(np.float32)), -1), 2, 80),
        (torch.full((8, 16), 1 / 16), 2, 1),
        (torch.softmax(torch.from_numpy(rng.integers(0, 3, (64, 8)).astype(
            np.float32)), -1), 2, 3)]
    for probs, k, cap in cases:
        a = moe.route(probs, k, cap)
        b = moe.route(probs.to(cuda), k, cap)
        for name in ("top_e", "order", "keep", "slot", "st", "pos_in_e"):
            assert torch.equal(getattr(a, name), getattr(b, name).cpu()), \
                name


def test_hybrid_decode_replays_bit_for_bit(cuda):
    """Jamba's period in bfloat16 served on the card: after a few
    requests, a decode step replayed from the same cache gives the same
    logits and cache bit for bit (the MoE combine adds in a fixed
    order; no float atomics), and the trace of a step holds no
    scatter_add / index_add kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import registry
    from repro_torch.serve import Engine, EngineConfig, Request
    from repro_torch.tree import leaves, tree_map

    cfg = _card_hybrid_config("jamba-v0.1-52b", "bfloat16")
    params = registry.get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(11), cuda)
    eng = Engine(cfg, params, EngineConfig(max_batch=8, max_context=128,
                                           block_size=16))
    rng = np.random.default_rng(12)
    eng.run([Request(req_id=i, prompt=rng.integers(1, cfg.vocab, 20 + 7 * i)
                     .tolist(), max_new_tokens=4) for i in range(6)])
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (8, 1)).astype(
        np.int32)).to(cuda)
    snap = tree_map(torch.clone, eng.cache)
    out = []
    for _ in range(2):
        eng.cache = tree_map(torch.clone, snap)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            logits = eng.decode(toks)
            torch.cuda.synchronize()
        out.append((logits, leaves(tree_map(torch.clone, eng.cache))))
    assert torch.equal(_bits(out[0][0]), _bits(out[1][0]))
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(_bits(a), _bits(b))
    names = [ev.key.lower() for ev in prof.key_averages()]
    assert names and not [n for n in names
                          if "scatter_add" in n or "index_add" in n]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "rwkv6-3b"])
def test_hybrid_engine_serves_on_the_card(cuda, arch):
    """float32 on the card: the engine's greedy tokens on the kernel path
    equal the plain path's (RWKV has no attention: its two runs are the
    same path), prompts of 10-300 tokens, every budget met."""
    from repro_torch.models import registry
    from repro_torch.serve import Engine, EngineConfig, Request

    cfg = _card_hybrid_config(arch, "float32")
    params = registry.get_model(cfg).init(
        torch.Generator(device=cuda).manual_seed(13), cuda)
    rng = np.random.default_rng(14)
    lengths = [(10, 5), (300, 4), (37, 6), (129, 3)]
    prompts = [rng.integers(1, cfg.vocab, p).tolist() for p, _ in lengths]
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for kern in (True, False):
        eng = Engine(cfg, params, EngineConfig(max_batch=3, max_context=512,
                                               block_size=16),
                     use_kernels=kern)
        out[kern] = eng.run([Request(req_id=i, prompt=list(p),
                                     max_new_tokens=m)
                             for i, (p, (_, m)) in enumerate(
                                 zip(prompts, lengths))])
    assert out[True] == out[False]
    assert {r: len(v) for r, v in out[True].items()} == \
        {i: m for i, (_, m) in enumerate(lengths)}


# ---------------------------------------------------------------------------
# the encoder-decoder (Whisper)
# ---------------------------------------------------------------------------

WHISPER_FLASH_CASES = [
    # bh, sq, skv, causal, bq, bk: Whisper's head dim 64 at lengths over
    # 128 that 128 does not divide (a tail tile of 92 rows at 1,500)
    (8, 1500, 1500, False, 125, 125),       # the encoder
    (8, 228, 1500, False, 114, 125),        # a prompt's cross-attention
    (8, 228, 228, True, 114, 114),          # a prompt's self-attention
    (8, 4, 1500, False, 4, 125),            # the start sequence's cross
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WHISPER_FLASH_CASES)
def test_whisper_flash_shapes_match_the_plain_version(cuda, case, dtype):
    from repro_torch.kernels import flash_attention_plain

    bh, sq, skv, causal, bq, bk = case
    q = _randn((bh, sq, 64), dtype, cuda, 0)
    k = _randn((bh, skv, 64), dtype, cuda, 1)
    v = _randn((bh, skv, 64), dtype, cuda, 2)
    reset_launch_counts()
    got = KERNELS["flash_attention"](q, k, v, causal, None, bq, bk)
    again = KERNELS["flash_attention"](q, k, v, causal, None, bq, bk)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 2
    want = flash_attention_plain(q, k, v, causal, None, bq, bk)
    assert _close(got, want, dtype) and torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s_kv,lengths", [(1500, None), (448, "seeded")])
def test_whisper_paged_views_match_the_plain_version(cuda, s_kv, lengths,
                                                     dtype):
    """Decode cross-attention: 1,500 keys as 4-token blocks, every length
    1,500; self-attention: the 448-token cache as 16-token blocks."""
    from repro_torch.kernels import paged_attention_plain
    from repro_torch.models.common import kv_index

    b, h, hd = 8, 20, 64
    idx = kv_index(b, s_kv, cuda)
    assert idx.block == (4 if s_kv == 1500 else 16)
    lens = idx.lengths if lengths is None else torch.from_numpy(
        np.random.default_rng(3).integers(1, s_kv + 1, b).astype(
            np.int32)).to(cuda)
    pool = (b * s_kv // idx.block, idx.block, h, hd)
    args = (_randn((b, h, hd), dtype, cuda, 0),
            _randn((b, s_kv, h, hd), dtype, cuda, 1).view(pool),
            _randn((b, s_kv, h, hd), dtype, cuda, 2).view(pool),
            idx.tables, lens)
    got = KERNELS["paged_attention"](*args)
    again = KERNELS["paged_attention"](*args)
    assert _close(got, paged_attention_plain(*args), dtype)
    assert torch.equal(got, again)


def test_whisper_float32_gate_at_full_width(cuda):
    """Whisper-large-v3's widths at 4 + 4 layers in float32 (TF32 off):
    two clips of 1,500 frames, a 228-token prompt and 8 teacher-forced
    decode steps through the kernels against the plain attention, within
    rtol = atol = 1e-3 (the smoke's float32 gate); 12 flash launches a
    prefill and 8 paged launches a step."""
    from repro_torch.configs import CONFIGS
    from repro_torch.models import registry

    cfg = dataclasses.replace(CONFIGS["whisper-large-v3"], n_layers=4,
                              n_encoder_layers=4, dtype="float32")
    api = registry.get_model(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(8), cuda)
    rng = np.random.default_rng(9)
    frames = torch.from_numpy(rng.normal(size=(2, 1500, cfg.d_model)).astype(
        np.float32)).to(cuda)
    toks = torch.from_numpy(rng.integers(1, 50257, (2, 236)).astype(
        np.int32)).to(cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = {}
    for kern in (True, False):
        reset_launch_counts()
        logits, cache = api.prefill(params, {"frames": frames,
                                             "tokens": toks[:, :228]}, 448,
                                    use_kernels=kern)
        out = [logits[:, 0]]
        for t in range(228, 236):
            step, cache = api.decode_step(params, cache, toks[:, t:t + 1],
                                          use_kernels=kern)
            out.append(step[:, 0])
        torch.cuda.synchronize()
        runs[kern] = (torch.stack(out, 1), launch_counts())
    (got, counts), (want, plain_counts) = runs[True], runs[False]
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, rtol=1e-3, atol=1e-3)
    assert counts["flash_attention"] == 12
    assert counts["paged_attention"] == 8 * 8
    assert sum(plain_counts.values()) == 0


@pytest.mark.parametrize("family", ["fd", "rmat", "banded"])
def test_generators_build_the_same_bytes_on_the_card(cuda, family):
    """`CSR.from_coo` sorts, gathers and counts rows on the card: the
    generators' CSR is the CPU's byte for byte."""
    from repro_torch.core import generators as tg

    make = {"fd": lambda d: tg.fd_matrix(4096, device=d),
            "rmat": lambda d: tg.rmat_matrix(4096, seed=3, device=d),
            "banded": lambda d: tg.banded_matrix(4096, 40, device=d)}[family]
    got, want = make(cuda), make("cpu")
    for name in ("data", "indices", "indptr"):
        a, b = getattr(got, name).cpu(), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the mesh slice: four ranks share the card over gloo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_moe_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: four ranks share it over gloo (the "
                    "CPU gloo worlds are tests/test_torch_mesh_moe.py)")
    from _mesh_worlds import card_moe_world as world

    from repro_torch.launch.mesh import launch
    return launch(world, 4, device="cuda")


@pytest.mark.parametrize("path,mesh", [
    ("sharded", "1x4"), ("a2a", "1x4"), ("sharded", "2x2"), ("a2a", "2x2"),
    ("decode", "2x2")])
def test_mesh_moe_path_on_four_ranks_of_the_card(card_moe_world, path,
                                                 mesh):
    """float32 at capacity factor 8 (no drops): each path within 1e-5 of
    max |y| of the global layer (decode, whose combine is a bfloat16
    psum, within 2^-7), every rank the same bits, a replay bit for
    bit."""
    key = f"{path} {mesh}"
    err, top, replay = card_moe_world[0][key]
    rtol = 2.0 ** -7 if path == "decode" else 1e-5
    assert err <= rtol * top, (err, top)
    assert replay
    assert all(r[key] == card_moe_world[0][key] for r in card_moe_world)


# ---------------------------------------------------------------------------
# the partitioned train step: two ranks share the card over gloo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_train_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: two ranks share it over gloo (the "
                    "CPU gloo worlds are tests/test_torch_mesh_train*.py)")
    from _mesh_train import card_train_rank

    from repro_torch.launch.mesh import launch
    return launch(card_train_rank, 2, device="cuda")


@pytest.mark.parametrize("mesh", ["1x2", "2x1"])
def test_partitioned_gradients_on_two_ranks_of_the_card(card_train_world,
                                                        mesh):
    """StableLM's reduced config in float32: each rank's gradients from
    its blocks and rows within 1e-4 of each leaf's max of the one-rank
    gradients on the card, the loss within rel 1e-5 and the same bits on
    both ranks."""
    loss, loss1, err = card_train_world[0][mesh]
    assert err <= 1e-4, err
    assert abs(loss / loss1 - 1) <= 1e-5, (loss, loss1)
    assert card_train_world[1][mesh][0] == loss
