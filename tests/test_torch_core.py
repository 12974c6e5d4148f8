"""Port vs reference: generators, containers, structure reports and
fingerprints must be identical for the same seed / the same matrix."""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import port_csr, same_csr

from repro.core import formats as rf
from repro.core import generators as rg
from repro.core import structure as rs
from repro.plan import fingerprint as rfp
from repro_torch.core import formats as tf
from repro_torch.core import generators as tg
from repro_torch.core import structure as ts
from repro_torch.device import to_numpy, to_tensor
from repro_torch.plan import fingerprint as tfp


@pytest.mark.parametrize("n", [16, 22, 37, 100, 1024, 4096])
@pytest.mark.parametrize("seed", [0, 3])
def test_fd_matrix_byte_identical(n, seed):
    """Same arrays and dtypes, including the duplicate coordinates the
    reference emits for degenerate grids (n = 22, 37)."""
    assert same_csr(rg.fd_matrix(n, seed=seed),
                    tg.fd_matrix(n, seed=seed, device="cpu"))


@pytest.mark.parametrize("n", [16, 256, 1024, 4096])
@pytest.mark.parametrize("seed", [0, 5])
def test_rmat_matrix_byte_identical(n, seed):
    assert same_csr(rg.rmat_matrix(n, seed=seed),
                    tg.rmat_matrix(n, seed=seed, device="cpu"))


def test_rmat_edges_and_unpermuted_matrix_identical():
    for a, b in zip(rg.rmat_edges(512, 4096, seed=9),
                    tg.rmat_edges(512, 4096, seed=9)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert same_csr(rg.rmat_matrix(256, nnz_per_row=4, seed=2,
                                   permute=False),
                    tg.rmat_matrix(256, nnz_per_row=4, seed=2,
                                   permute=False, device="cpu"))
    with pytest.raises(ValueError):
        tg.rmat_edges(100, 10)


def test_csr_from_numpy_keeps_bytes_and_device():
    ref = rg.rmat_matrix(256, seed=1)
    port = port_csr(ref)
    assert same_csr(ref, port) and port.device == torch.device("cpu")
    assert port.nnz == ref.nnz and port.shape == ref.shape
    assert port.storage_bytes() == ref.storage_bytes()
    assert port.to("cpu").data is port.data     # no copy on its device


def test_from_coo_refuses_out_of_range_coordinates():
    with pytest.raises(ValueError):
        tf.CSR.from_coo([0, 4], [0, 1], [1.0, 1.0], 4, 4, device="cpu")
    with pytest.raises(ValueError):
        tf.CSR.from_coo([0, 1], [0, 4], [1.0, 1.0], 4, 4, device="cpu")


@pytest.mark.parametrize("case", ["duplicates", "empty rows", "no entries",
                                  "one column", "bfloat16"])
def test_from_coo_card_steps_equal_the_host_steps(case):
    """`CSR.from_coo`'s torch steps (the same on the card; here on the
    CPU) build the reference's CSR byte for byte: dtypes too,
    duplicates in stream order; `csr_from_coo_tensors` over the same
    tensors gives the same bytes."""
    rng = np.random.default_rng(17)
    n_rows, n_cols, nnz = {"duplicates": (40, 30, 900),
                           "empty rows": (500, 64, 200),
                           "no entries": (8, 8, 0), "one column": (64, 1, 300),
                           "bfloat16": (40, 30, 900)}[case]
    rows = rng.integers(0, n_rows, nnz)
    cols = rng.integers(0, n_cols, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    dtype = np.float32
    if case == "bfloat16":
        import ml_dtypes
        dtype = ml_dtypes.bfloat16
    got = tf.CSR.from_coo(rows, cols, vals, n_rows, n_cols, dtype=dtype,
                          device="cpu")
    ref = rf.CSR.from_coo(rows, cols, vals, n_rows, n_cols, dtype=dtype)
    for name in ("data", "indices", "indptr"):
        a, b = np.asarray(getattr(ref, name)), getattr(got, name)
        if case == "bfloat16" and name == "data":   # numpy reads no
            assert b.dtype == torch.bfloat16         # torch bf16: words
            a, b = a.view(np.uint16), b.view(torch.int16).numpy().view(
                np.uint16)
        else:
            b = b.numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    direct = tf.csr_from_coo_tensors(
        torch.from_numpy(rows), torch.from_numpy(cols),
        to_tensor(np.asarray(vals, dtype), "cpu"), n_rows, n_cols)
    for name in ("data", "indices", "indptr"):
        a, b = getattr(got, name), getattr(direct, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _reports_equal(ref_csr, port, **kw):
    a = dataclasses.asdict(rs.analyze(ref_csr, **kw))
    b = dataclasses.asdict(ts.analyze(port, **kw))
    assert a == b
    return b


@pytest.mark.parametrize("family,n", [("fd", 1024), ("fd", 4096),
                                      ("fd", 22), ("rmat", 1024),
                                      ("rmat", 4096), ("banded", 2048),
                                      ("uniform", 1024)])
def test_structure_report_identical(family, n):
    ref = {"fd": rg.fd_matrix, "rmat": rg.rmat_matrix,
           "banded": lambda m: rg.banded_matrix(m, 40),
           "uniform": rg.uniform_random_matrix}[family](n)
    rep = _reports_equal(ref, port_csr(ref))
    assert rep["kind"] in ("banded", "blocked", "unstructured")


def test_structure_report_identical_when_sampled():
    """Above `sample_rows` both analyse the same eight row windows."""
    ref = rg.rmat_matrix(4096, seed=4)
    _reports_equal(ref, port_csr(ref), sample_rows=1024)


def test_structure_report_of_empty_matrix():
    z = np.array([], dtype=np.int64)
    ref = rf.CSR.from_coo(z, z, np.array([], np.float32), 8, 8)
    _reports_equal(ref, port_csr(ref))


def _containers(fmt, ref, port, fill):
    if fmt == "ell":
        return (rf.ELL.from_csr(ref, fill=fill),
                tf.ELL.from_csr(port, fill=fill))
    if fmt == "dia":
        return rf.DIA.from_csr(ref), tf.DIA.from_csr(port)
    return (rf.HYB.from_csr(ref, fill=fill),
            tf.HYB.from_csr(port, fill=fill))


@pytest.mark.parametrize("fmt,fill", [("ell", 0.0), ("ell", np.inf),
                                      ("hyb", 0.0), ("hyb", np.inf),
                                      ("dia", 0.0)])
@pytest.mark.parametrize("family,n", [("fd", 22), ("fd", 1024),
                                      ("rmat", 1024), ("empty", 8)])
def test_converted_containers_and_fingerprints_identical(fmt, fill, family,
                                                         n):
    """Every array leaf of ELL / DIA / HYB (the vectorised DIA
    conversion included, duplicates and all) matches the reference
    byte for byte, so the container fingerprints agree."""
    if family == "empty":
        z = np.array([], dtype=np.int64)
        ref = rf.CSR.from_coo(z, z, np.array([], np.float32), n, n)
    else:
        ref = {"fd": rg.fd_matrix, "rmat": rg.rmat_matrix}[family](n)
    a, b = _containers(fmt, ref, port_csr(ref), fill)
    leaves = [f.name for f in dataclasses.fields(a)
              if f.name not in a._static]
    for name in leaves:
        x, y = np.asarray(getattr(a, name)), to_numpy(getattr(b, name))
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert rfp.matrix_fingerprint(a) == tfp.matrix_fingerprint(b)
    if fmt == "hyb":
        assert (a.threshold, a.light_width) == (b.threshold, b.light_width)


@pytest.mark.parametrize("n", [16, 1024])
def test_csr_fingerprints_identical(n):
    ref = rg.rmat_matrix(n, seed=7)
    port = port_csr(ref)
    assert rfp.matrix_fingerprint(ref) == tfp.matrix_fingerprint(port)
    assert tfp.matrix_fingerprint(port) == tfp.matrix_fingerprint(port)
    assert rfp.fingerprint_arrays(np.arange(5), extra="x") == \
        tfp.fingerprint_arrays(torch.arange(5), extra="x")


def test_hyb_auto_threshold_matches_reference():
    for lens in ([], [1], [0, 0, 9], [3, 5, 1, 40, 2]):
        assert rf.hyb_auto_threshold(lens) == tf.hyb_auto_threshold(lens)
