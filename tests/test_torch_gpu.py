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
from _torch_parity import (FAMILIES, SEMIRING_NAMES, blocked_coo,
                           port_int_operands)

from repro_torch.graph import drivers as tdrv
from repro_torch.graph.semiring import SEMIRINGS
from repro_torch.kernels import (KERNELS, _layout as tkl, launch_counts,
                                 reset_launch_counts)
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


@pytest.mark.parametrize("fmt", ["csr-seg", "hyb"])
@pytest.mark.parametrize("sr_name", SEMIRING_NAMES)
def test_long_rows_are_merged_by_a_block(cuda, fmt, sr_name):
    """A hub row cut into more than LONG_ROW partials takes the
    block-per-row merge and still equals the plain version exactly."""
    csr, x = port_int_operands("single-dense-row", 300, 11, sr_name)
    sr = SEMIRINGS[sr_name]
    cpu_prep, run = _layouts(fmt, csr, sr, seg_len=4)
    heavy = cpu_prep if fmt == "csr-seg" else cpu_prep.heavy
    assert heavy.long_rows.numel() > 0
    gpu_prep, _ = _layouts(fmt, csr.to(cuda), sr, seg_len=4)
    want = run(cpu_prep, torch.from_numpy(x), sr)
    got = run(gpu_prep, torch.from_numpy(x).to(cuda), sr)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("fmt", ["dia", "ell", "csr", "hyb"])
def test_kernel_real_valued_plus_times_within_tolerance(cuda, fmt):
    """Real values: summation order may differ from the plain version on
    the card (its segment sums use atomics), so rtol 1e-5."""
    from repro_torch.core.generators import rmat_matrix, fd_matrix

    csr = (fd_matrix if fmt == "dia" else rmat_matrix)(4096, device=cuda)
    sr = SEMIRINGS["plus_times"]
    prep, run = _layouts(fmt, csr, sr)
    x = torch.rand(4096, device=cuda)
    got = run(prep, x, sr)
    plain = tcompile(csr, format=fmt, use_pallas=False,
                     device=cuda).execute(x)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)


def test_each_wrapper_counts_only_its_launches(cuda):
    csr = port_int_operands("rmat", 256, 1, "plus_times", device=cuda)[0]
    reset_launch_counts()
    p = tcompile(csr, device=cuda)                       # hyb
    p.execute(torch.ones(256, device=cuda))
    assert launch_counts() == {"spmv_dia": 0, "spmv_ell": 1, "spmv_csr": 0,
                               "spmv_csr_seg": 1, "spmv_bell": 0}
    p.execute_many(torch.ones(2, 256, device=cuda))     # plain SpMM
    assert sum(launch_counts().values()) == 2
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
        prep = dataclasses.replace(prep, blocks=torch.rand(
            prep.blocks.shape, device=cuda) * (prep.blocks != 0))
    gen = torch.Generator().manual_seed(1)
    x = (torch.randint(-8, 9, (prep.n_cols,), generator=gen).float()
         if kind == "int" else torch.rand(prep.n_cols, generator=gen))
    x = x.to(cuda)
    args = (prep.blocks, prep.block_cols, prep.block_ptr, prep.pad0, x,
            prep.n_rows)
    reset_launch_counts()
    got = KERNELS["spmv_bell"](*args)
    torch.cuda.synchronize()
    from repro_torch.kernels import spmv_bell_plain

    assert torch.equal(got, spmv_bell_plain(*args))
    assert launch_counts()["spmv_bell"] == (1 if prep.n_rows else 0)


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
    assert torch.equal(plan.execute(xt),
                       tcompile(scrambled, device=cuda).execute(xt))
