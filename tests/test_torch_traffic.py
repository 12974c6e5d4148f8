"""Port vs reference: the SpMV traffic model (`repro_torch.core.traffic`).

Under the reference's device constants (read from
`repro.core.traffic.TPU_V5E` and passed in) every policy's
`TrafficReport` equals the reference's field for field; the port's own
default is the H100's figures.
"""
import dataclasses

import pytest
from _torch_parity import port_csr

from repro.core import generators as rg
from repro.core import traffic as rt
from repro.core.formats import BELL as RBELL
from repro_torch.core import traffic as tt

MATRICES = {
    "fd": lambda n: rg.fd_matrix(n),
    "rmat": lambda n: rg.rmat_matrix(n),
    "banded": lambda n: rg.banded_matrix(n, 8),
}


def _policies(mod, csr, dev, density):
    return {
        "gather": mod.gather_policy(csr, dev),
        "stream": mod.stream_policy(csr, 70, dev),
        "stream-narrow": mod.stream_policy(csr, 0, dev),
        "col-block": mod.col_blocked_policy(csr, None, dev),
        "col-block-4": mod.col_blocked_policy(csr, 4, dev),
        "bell": mod.bell_policy(density, csr, dev),
    }


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("log2n", [10, 12])
def test_policies_equal_the_references_under_its_constants(name, log2n):
    ref = MATRICES[name](1 << log2n)
    port = port_csr(ref)
    consts = tt.DeviceModel(**dataclasses.asdict(rt.TPU_V5E))
    density = RBELL.from_csr(ref).density()
    want = _policies(rt, ref, rt.TPU_V5E, density)
    got = _policies(tt, port, consts, density)
    for key in want:
        assert dataclasses.asdict(got[key]) == dataclasses.asdict(want[key])
        assert got[key].summary() == want[key].summary()


def test_the_default_is_the_h100():
    dev = tt.H100
    assert (dev.hbm_bw, dev.peak_flops_bf16) == (3.35e12, 989e12)
    assert dev.vmem_bytes == 50 * 2 ** 20 and dev.name.startswith("NVIDIA")
    csr = port_csr(rg.fd_matrix(1 << 12))
    best = tt.col_blocked_policy(csr)
    assert best.roofline_gflops <= dev.peak_flops_bf16 / 1e9
    # SpMV stays bandwidth-bound on the card too
    assert best.arithmetic_intensity < dev.peak_flops_bf16 / dev.hbm_bw / 100
    assert tt.gather_policy(csr).bytes_per_nnz > best.bytes_per_nnz
