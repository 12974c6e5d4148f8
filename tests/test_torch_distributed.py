"""Port vs reference: row-sharded ELL plans (`repro_torch.distributed`).

The slabs `prepare_ell_shards` packs are byte-equal to the reference's
(a sharded plan's checkpoint stores them); `spmv_row_sharded` over
repeated CPU devices -- the reference's 8-shard case of
`tests/test_multidevice.py` -- equals the CSR SpMV bit for bit on
integer-valued operands; the refusals carry the reference's messages.
"""
import numpy as np
import pytest
import torch
from _torch_parity import int_operands, port_csr

from repro.core import generators as rg
from repro.core.partition import rowblock_balanced as r_balanced
from repro.core.partition import rowblock_equal as r_equal
from repro.kernels import _layout as rkl
from repro_torch import kernels as K
from repro_torch import plan as tplan
from repro_torch.core import generators as tg
from repro_torch.core.partition import rowblock_balanced, rowblock_equal
from repro_torch.distributed import (RowMesh, default_row_partition,
                                     row_mesh, spmv_row_sharded)
from repro_torch.kernels import _layout as tkl


def _ref_default_partition(csr, n_shards):
    """The reference's `default_row_partition` without a JAX mesh."""
    from repro.core.partition import RowPartition

    if n_shards <= csr.n_rows:
        return r_equal(csr, n_shards)
    starts = np.minimum(np.arange(n_shards + 1, dtype=np.int64), csr.n_rows)
    indptr = np.asarray(csr.indptr, dtype=np.int64)
    return RowPartition(starts=starts,
                        nnz_per_part=indptr[starts[1:]] - indptr[starts[:-1]])


CASES = {
    "rmat512-1": (lambda: rg.rmat_matrix(512, seed=9), "equal", 1),
    "rmat512-3": (lambda: rg.rmat_matrix(512, seed=9), "equal", 3),
    "rmat512-8": (lambda: rg.rmat_matrix(512, seed=9), "equal", 8),
    "fd1024-4": (lambda: rg.fd_matrix(1024), "equal", 4),
    "rmat4-8-padded": (lambda: rg.rmat_matrix(4, seed=0), "equal", 8),
    "rmat512-balanced-8": (lambda: rg.rmat_matrix(512, seed=9),
                           "balanced", 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_ell_shards_is_byte_equal(case):
    make, how, parts = CASES[case]
    ref = make()
    port = port_csr(ref)
    if how == "balanced":
        rpart, tpart = r_balanced(ref, parts), rowblock_balanced(port, parts)
    else:
        rpart = _ref_default_partition(ref, parts)
        tpart = default_row_partition(port, row_mesh(["cpu"] * parts))
    assert np.array_equal(rpart.starts, tpart.starts)
    r = rkl.prepare_ell_shards(ref, rpart)
    t = tkl.prepare_ell_shards(port, tpart)
    for a, b in ((r.data, t.data), (r.idx, t.idx), (r.starts, t.starts)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    assert (r.n_rows, r.n_cols, r.bm) == (t.n_rows, t.n_cols, t.bm)


@pytest.mark.parametrize("family", ["rmat", "fd", "single-dense-row"])
@pytest.mark.parametrize("balanced", [False, True])
def test_row_sharded_equals_csr_on_eight_cpu_slabs(family, balanced):
    """Eight slabs on repeated CPU devices, one ELL launch each (the
    plain version on the CPU): bit-identical to the CSR plan."""
    ref, x = int_operands(family, 512, 9, "plus_times")
    csr = port_csr(ref)
    mesh = row_mesh(["cpu"] * 8)
    part = rowblock_balanced(csr, 8) if balanced else None
    want = tplan.compile(csr, format="csr", reorder="none",
                         predictor="none", device="cpu").execute(x)
    got = spmv_row_sharded(csr, x, mesh=mesh, partition=part)
    assert torch.equal(got, want)
    p = tplan.compile(csr, mesh=mesh, partition=part, reorder="none",
                      predictor="none")
    assert p.format_name == "ell-sharded" and p.device.type == "cpu"
    assert p.prep.n_parts == 8 and torch.equal(p.execute(x), want)
    assert torch.equal(p.execute_many(np.stack([x, 2 * x])),
                       torch.stack([want, 2 * want]))


def test_fewer_rows_than_slabs():
    ref = rg.rmat_matrix(4, seed=0)
    csr = port_csr(ref)
    y = spmv_row_sharded(csr, np.ones(4, np.float32),
                         mesh=row_mesh(["cpu"] * 8))
    assert torch.equal(y, torch.as_tensor(
        np.asarray(ref.to_dense()) @ np.ones(4, np.float32)))


def test_one_launch_per_slab_through_the_ell_wrapper(monkeypatch):
    """Each slab goes through `kernels.spmv_ell` (the plain version on
    CPU tensors): four slabs, four calls."""
    import repro_torch.distributed.spmv as dspmv

    calls = []
    real = dspmv.spmv_ell
    monkeypatch.setattr(dspmv, "spmv_ell",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    csr = tg.fd_matrix(1024, device="cpu")
    p = tplan.compile(csr, mesh=row_mesh(["cpu"] * 4), reorder="none",
                      predictor="none")
    K.reset_launch_counts()
    p.execute(np.ones(1024, np.float32))
    assert len(calls) == 4 and K.launch_counts()["spmv_ell"] == 0
    assert all(s == (128, 256) for s in calls)     # (W, rows_pad) slabs


def test_refusals_carry_the_reference_messages():
    csr = tg.fd_matrix(64, device="cpu")
    mesh = row_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="partition has 2 parts for 4 "
                       "devices on axis 'shards'"):
        spmv_row_sharded(csr, np.ones(64, np.float32), mesh=mesh,
                         partition=rowblock_equal(csr, 2))
    with pytest.raises(ValueError, match="sharded plans are plus-times only"):
        tplan.compile(csr, mesh=mesh, semiring="min_plus", device="cpu")
    p = tplan.compile(csr, mesh=mesh, reorder="none", predictor="none")
    p.mesh = None
    with pytest.raises(ValueError, match="sharded plan has no mesh bound; "
                       "pass mesh= to load_plan or set plan.mesh"):
        p.execute(np.ones(64, np.float32))


def test_mesh_and_partition_key_the_cache():
    """The reference's token scheme, with the torch devices' names: a
    mesh of CPU slabs and one of card slabs key apart."""
    csr = tg.rmat_matrix(256, device="cpu")
    mesh = row_mesh(["cpu"] * 4)
    key = tplan.PlanCache.key_for(csr, mesh=mesh,
                                  partition=rowblock_equal(csr, 4))
    assert ("mesh=mesh:OrderedDict({'shards': 4}):"
            "['cpu', 'cpu', 'cpu', 'cpu']") in key
    assert ";partition=part:" in key
    assert key != tplan.PlanCache.key_for(
        csr, mesh=mesh, partition=rowblock_balanced(csr, 4))
    cards = RowMesh(devices=(torch.device("cuda", 0),) * 4)
    card_key = tplan.PlanCache.key_for(csr, mesh=cards,
                                       partition=rowblock_equal(csr, 4))
    assert "['cuda:0', 'cuda:0', 'cuda:0', 'cuda:0']" in card_key
    assert card_key != key


def test_row_mesh_defaults_to_every_card():
    if torch.cuda.is_available():
        assert row_mesh().devices == tuple(
            torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            row_mesh()
