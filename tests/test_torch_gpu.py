"""The hand-written CUDA kernels on the card, against their plain
versions.  Every test needs a CUDA card and skips without one (the
decision is made in the `cuda` fixture, never at import).  Run them on
the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch
from _torch_parity import FAMILIES, SEMIRING_NAMES, port_int_operands

from repro_torch.graph import drivers as tdrv
from repro_torch.graph.semiring import SEMIRINGS
from repro_torch.kernels import (KERNELS, _layout as tkl, launch_counts,
                                 reset_launch_counts)
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
                               "spmv_csr_seg": 1}
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
