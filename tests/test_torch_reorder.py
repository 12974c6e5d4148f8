"""Port vs reference: reordering, the per-call SpMV API and reordered
plans.

Every strategy of `STRATEGIES` must give the reference's permutations
byte for byte (same `strategy`, `params`, `stats`) and the same permuted
CSR; `auto_format` / `compile` must pick the reference's format and
reordering with the reference's cache keys; reordered multiplies --
per-call, compiled, batched, and inside the graph drivers -- must return
the reference's values in the original order.  Matrices are made from
numpy seeds at 2^12 rows or fewer; the reference runs its kernels in
Pallas interpret mode.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import blocked_coo, port_csr, same_csr

from repro import plan as rplan
from repro import reorder as R
from repro.core import formats as rf
from repro.core import generators as rg
from repro.core import structure as rs
from repro.core.spmv import auto_format as r_auto_format
from repro.core.spmv import spmv as r_spmv
from repro.graph import drivers as rdrv
from repro.kernels import ops as rops
from repro_torch import plan as tplan
from repro_torch import reorder as T
from repro_torch.core import formats as tf
from repro_torch.core import structure as ts
from repro_torch.core.spmv import auto_format, spmv
from repro_torch.graph import drivers as tdrv
from repro_torch.graph.semiring import SEMIRINGS
from repro_torch.kernels import ops as tops
from repro_torch.plan import fingerprint as tfp


def _scrambled_banded(n, seed=0, bandwidth=8):
    """`banded_matrix` under a seeded symmetric permutation (the README
    example)."""
    p = np.random.default_rng(seed).permutation(n)
    return R.Reordering(row_perm=p, col_perm=p).apply(
        rg.banded_matrix(n, bandwidth=bandwidth))


def _blocked(n=1024, n_blocks=12, seed=0):
    rows, cols, vals = blocked_coo(n, n_blocks, seed)
    return rf.CSR.from_coo(rows, cols, vals, n, n)


MATRICES = {
    "fd": lambda: rg.fd_matrix(1 << 12, seed=1),
    "rmat": lambda: rg.rmat_matrix(1 << 12, seed=1),
    "scrambled-banded": lambda: _scrambled_banded(1 << 12),
    "blocked": lambda: _blocked(),
}


def _same_reordering(a, b):
    return (a.row_perm.dtype == b.row_perm.dtype == np.int64
            and a.col_perm.dtype == b.col_perm.dtype == np.int64
            and np.array_equal(a.row_perm, b.row_perm)
            and np.array_equal(a.col_perm, b.col_perm)
            and (a.strategy, a.params, a.stats) ==
            (b.strategy, b.params, b.stats))


def _int_valued(ref, seed=0):
    """Same pattern, integer values in [-8, 8] \\ {0}: every float32 sum
    is exact, so every summation order gives the same bits."""
    vals = np.random.default_rng(seed).integers(-8, 9, ref.nnz)
    vals[vals == 0] = 1
    return rf.CSR(data=jnp.asarray(vals.astype(np.float32)),
                  indices=ref.indices, indptr=ref.indptr,
                  n_rows=ref.n_rows, n_cols=ref.n_cols)


def _int_x(n, seed=1):
    return np.random.default_rng(seed).integers(-8, 9, n) \
        .astype(np.float32)


@pytest.mark.parametrize("strategy", list(R.STRATEGIES))
@pytest.mark.parametrize("matrix", list(MATRICES))
def test_strategies_byte_identical(matrix, strategy):
    """Same permutations, provenance and permuted matrix."""
    ref = MATRICES[matrix]()
    port = port_csr(ref)
    a = R.STRATEGIES[strategy](ref)
    b = T.STRATEGIES[strategy](port)
    assert isinstance(b, T.Reordering)
    assert _same_reordering(a, b)
    assert same_csr(a.apply(ref), b.apply(port))


def test_rcm_on_a_rectangular_and_a_disconnected_matrix():
    """Non-square: each side keeps its own id range; many components,
    isolated nodes included."""
    rng = np.random.default_rng(3)
    rect = rf.CSR.from_coo(rng.integers(0, 300, 900),
                           rng.integers(0, 500, 900),
                           np.ones(900, np.float32), 300, 500)
    blocks = [(rng.integers(0, 40, 60) + 50 * k) for k in range(8)]
    rows = np.concatenate(blocks)
    cols = np.concatenate([b[::-1] for b in blocks])
    islands = rf.CSR.from_coo(rows, cols, np.ones(rows.size, np.float32),
                              512, 512)
    for ref in (rect, islands):
        assert _same_reordering(R.rcm(ref), T.rcm(port_csr(ref)))


@pytest.mark.parametrize("min_nodes", [1, 1 << 30])
@pytest.mark.parametrize("matrix", list(MATRICES) + ["islands"])
def test_rcm_both_searches_byte_identical(matrix, min_nodes, monkeypatch):
    """RCM's two breadth-first searches -- scipy's for every component
    (min_nodes 1), a level at a time for every one (2^30) -- each give
    the reference's permutation."""
    from repro_torch.reorder import strategies
    if matrix == "islands":
        rng = np.random.default_rng(5)
        rows = rng.integers(0, 2048, 1500)
        ref = rf.CSR.from_coo(rows, (rows + rng.integers(1, 4, 1500)) % 2048,
                              np.ones(1500, np.float32), 2048, 2048)
    else:
        ref = MATRICES[matrix]()
    monkeypatch.setattr(strategies, "BFS_MIN_NODES", min_nodes)
    assert _same_reordering(R.rcm(ref), T.rcm(port_csr(ref)))


def test_permute_byte_identical_with_duplicates_and_refusals():
    """FD at n = 22 keeps its duplicate coordinates (ROADMAP C1) through
    `permute`; a non-permutation is refused as in the reference."""
    ref = rg.fd_matrix(22)
    port = port_csr(ref)
    p = np.random.default_rng(0).permutation(22)
    q = np.random.default_rng(1).permutation(22)
    assert same_csr(ref.permute(p, q), port.permute(p, q))
    assert same_csr(ref.permute(None, q), port.permute(None, q))
    bad = np.arange(22)
    bad[1] = 0
    with pytest.raises(ValueError, match="not a permutation"):
        port.permute(row_perm=bad)
    with pytest.raises(ValueError, match="not a permutation"):
        port.permute(col_perm=np.arange(21))


def test_reordering_helpers_match_reference():
    ref = rg.rmat_matrix(256, seed=2)
    a, b = R.rcm(ref), T.rcm(port_csr(ref))
    assert np.array_equal(a.inv_row_perm, b.inv_row_perm)
    assert np.array_equal(a.inv_col_perm, b.inv_col_perm)
    assert a.summary() == b.summary()
    c = a.then(R.degree_sort(a.apply(ref)))
    d = b.then(T.degree_sort(b.apply(port_csr(ref))))
    assert _same_reordering(c, d)
    assert T.is_permutation(b.row_perm, 256) and \
        not T.is_permutation(np.zeros(256), 256)
    assert np.array_equal(T.invert_permutation(b.row_perm),
                          R.invert_permutation(a.row_perm))
    ident = T.identity_reordering(5, 7)
    assert ident.shape == (5, 7) and ident.strategy == "identity"
    with pytest.raises(ValueError, match="not a permutation"):
        dataclasses.replace(b, row_perm=np.zeros(256, np.int64)).validate()


def test_permute_x_and_restore_y():
    """Gather / scatter along the last axis, for a vector and a batch,
    equal the reference's; the index tensors are uploaded once."""
    ref = rg.rmat_matrix(256, seed=3)
    a = R.cache_block(ref)
    b = T.cache_block(port_csr(ref))
    b = T.Reordering(row_perm=np.random.default_rng(4).permutation(256)
                     .astype(np.int64), col_perm=b.col_perm)
    a = R.Reordering(row_perm=b.row_perm, col_perm=a.col_perm)
    x = np.random.default_rng(5).normal(size=256).astype(np.float32)
    assert np.array_equal(b.permute_x(torch.from_numpy(x)).numpy(),
                          np.asarray(a.permute_x(jnp.asarray(x))))
    assert np.array_equal(b.restore_y(torch.from_numpy(x)).numpy(),
                          np.asarray(a.restore_y(jnp.asarray(x))))
    X = torch.from_numpy(np.stack([x, 2 * x]))
    assert torch.equal(b.permute_x(X)[1], b.permute_x(X[1]))
    assert torch.equal(b.restore_y(b.permute_x(X)),
                       X[:, b.col_perm][:, b.inv_row_perm])
    idx = b.index("col_perm", "cpu")
    b.permute_x(X)
    assert b.index("col_perm", "cpu") is idx and idx.dtype == torch.int64


@pytest.mark.parametrize("strategy", ["rcm", "degree-sort", "cache-block"])
@pytest.mark.parametrize("matrix", ["rmat", "scrambled-banded"])
def test_analyze_after_reordering_identical(matrix, strategy):
    ref = MATRICES[matrix]()
    a = R.STRATEGIES[strategy](ref)
    b = T.STRATEGIES[strategy](port_csr(ref))
    da = rs.analyze_reorder(ref, a)
    db = ts.analyze_reorder(port_csr(ref), b)
    assert dataclasses.asdict(db.before) == dataclasses.asdict(da.before)
    assert dataclasses.asdict(db.after) == dataclasses.asdict(da.after)
    assert (db.summary(), db.improved(), db.changes()) == \
        (da.summary(), da.improved(), da.changes())
    assert ts.analyze(port_csr(ref), reordering=b) == db.after


# ---------------------------------------------------------------------------
# auto_format and spmv (mirrors tests/test_auto_format.py)
# ---------------------------------------------------------------------------

ROUTES = {
    "banded": (lambda: rg.fd_matrix(1024), tf.DIA),
    "narrow-band": (lambda: rg.banded_matrix(512, 8, nnz_per_row=5, seed=2),
                    tf.DIA),
    "blocked": (_blocked, tf.BELL),
    "power-law": (lambda: rg.rmat_matrix(2048, seed=5), tf.HYB),
    "flat-unstructured": (lambda: rg.uniform_random_matrix(
        2048, nnz_per_row=8, seed=5), tf.CSR),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_auto_format_routes_like_the_reference(route):
    """Same container type and bytes (fingerprint), and `spmv` through
    the kernels' plain versions equals the reference's bit for bit on
    integer values."""
    gen, want_type = ROUTES[route]
    ref = _int_valued(gen())
    got = auto_format(port_csr(ref))
    want = r_auto_format(ref)
    assert isinstance(got, want_type)
    assert type(got).__name__ == type(want).__name__
    assert tfp.matrix_fingerprint(got) == \
        rplan.fingerprint.matrix_fingerprint(want)
    x = _int_x(ref.n_cols)
    y_ref = np.asarray(r_spmv(want, jnp.asarray(x)))
    assert np.array_equal(spmv(got, torch.from_numpy(x)).numpy(), y_ref)
    assert np.array_equal(
        spmv(got, torch.from_numpy(x), use_pallas=False).numpy(), y_ref)


def test_auto_format_keeps_csr_for_too_many_offsets_and_threads_bias():
    ref = rg.banded_matrix(512, 200, nnz_per_row=7, seed=3)
    rep = ts.analyze(port_csr(ref))
    wide = dataclasses.replace(rep, kind="banded", n_distinct_offsets=100)
    port = port_csr(ref)
    assert auto_format(port, wide) is port
    disp = rg.uniform_random_matrix(2048, nnz_per_row=8, seed=5)
    rep = rs.analyze(disp)
    seg = dataclasses.replace(rep, row_nnz_cv=0.7)
    tseg = dataclasses.replace(ts.analyze(port_csr(disp)), row_nnz_cv=0.7)
    assert type(auto_format(port_csr(disp), tseg, threads=4)).__name__ == \
        type(r_auto_format(disp, seg, threads=4)).__name__


def test_readme_scrambled_banded_example():
    """reorder -> re-decide the format (CSR -> DIA) -> multiply in the
    original order, as the README shows for the reference."""
    n = 1 << 10
    ref = _scrambled_banded(n)
    port = port_csr(ref)
    r = T.rcm(port)
    assert not isinstance(auto_format(port), tf.DIA)
    fmt = auto_format(port, reordering=r)
    assert isinstance(fmt, tf.DIA)
    x = torch.ones(n)
    y = spmv(fmt, x, reordering=r)
    assert np.allclose(y.numpy(), spmv(port, x).numpy(), atol=1e-4)
    want = np.asarray(r_spmv(r_auto_format(ref, reordering=R.rcm(ref)),
                             jnp.ones(n, jnp.float32),
                             reordering=R.rcm(ref)))
    assert np.array_equal(y.numpy(), want)


@pytest.mark.parametrize("strategy", list(R.STRATEGIES))
def test_per_call_spmv_under_every_strategy(strategy):
    ref = _int_valued(rg.rmat_matrix(256, seed=1))
    port = port_csr(ref)
    x = torch.from_numpy(_int_x(256, seed=3))
    r = T.STRATEGIES[strategy](port)
    y = spmv(r.apply(port), x, reordering=r)
    assert torch.equal(y, spmv(port, x))


def test_spmv_caches_one_plan_per_container():
    port = port_csr(_int_valued(rg.fd_matrix(256)))
    before = tplan.DEFAULT_CACHE.stats()
    x = torch.from_numpy(_int_x(256))
    y1, y2 = spmv(port, x), spmv(port, x)
    after = tplan.DEFAULT_CACHE.stats()
    assert torch.equal(y1, y2)
    assert after["compiles"] == before["compiles"] + 1
    assert after["hits"] == before["hits"] + 1
    key = tfp.matrix_fingerprint(port) + "|container"
    assert tplan.DEFAULT_CACHE.contains(key)
    with pytest.raises(TypeError, match="unsupported"):
        spmv(np.eye(3), torch.ones(3))


# ---------------------------------------------------------------------------
# compile(reorder=...)
# ---------------------------------------------------------------------------

def _reorder_opts(kind, ref, port):
    """(reference option, port option) for one `reorder=` form."""
    if kind == "Reordering":
        return R.rcm(ref), T.rcm(port)
    return kind, kind


@pytest.mark.parametrize("kind", ["none", "rcm", "degree-sort",
                                  "cache-block", "rcm+cache-block",
                                  "Reordering"])
@pytest.mark.parametrize("matrix", ["rmat", "scrambled-banded"])
def test_compile_reorder_matches_reference(matrix, kind):
    """Same format, chosen label, reordering, compile_stats keys, cache
    key and summary; `execute` in the original order, bit for bit."""
    ref = _int_valued(MATRICES[matrix]())
    port = port_csr(ref)
    ropt, topt = _reorder_opts(kind, ref, port)
    assert rplan.PlanCache.key_for(ref, reorder=ropt, predictor="none") == \
        tplan.PlanCache.key_for(port, reorder=topt, predictor="none")
    p = rplan.compile(ref, reorder=ropt, predictor="none")
    tp = tplan.compile(port, reorder=topt, predictor="none", device="cpu")
    assert (tp.format_name, tp.chosen, tp.summary()) == \
        (p.format_name, p.chosen, p.summary())
    assert list(tp.compile_stats) == list(p.compile_stats)
    assert (tp.reordering is None) == (p.reordering is None)
    if p.reordering is not None:
        assert _same_reordering(p.reordering, tp.reordering)
        assert same_csr(p.csr, tp.csr)
    x = _int_x(ref.n_cols, seed=7)
    want = np.asarray(p.execute(jnp.asarray(x)))
    assert np.array_equal(tp.execute(torch.from_numpy(x)).numpy(), want)
    X = np.stack([x, _int_x(ref.n_cols, seed=8)])
    assert np.array_equal(tp.execute_many(torch.from_numpy(X)).numpy(),
                          np.asarray(p.execute_many(jnp.asarray(X))))
    lam, _ = tp.power_iteration(torch.ones(ref.n_cols), n_iters=3)
    assert torch.isfinite(lam)


def test_scrambled_banded_compiles_to_dia_only_after_rcm():
    ref = _scrambled_banded(1 << 12)
    port = port_csr(ref)
    assert tplan.compile(port, reorder="none", predictor="none",
                         device="cpu").format_name == \
        rplan.compile(ref, reorder="none", predictor="none").format_name \
        != "dia"
    tp = tplan.compile(port, reorder="rcm", device="cpu")
    assert tp.format_name == "dia" and tp.chosen == "rcm"
    assert tp.report.kind == "banded"
    # 'auto' without a predictor is the identity order, as in the
    # reference; with one, the scored decision is the reference's
    assert tplan.compile(port, reorder="auto", predictor="none",
                         device="cpu").reordering is None
    for predictor in ("auto", "oracle"):
        p = rplan.compile(ref, reorder="auto", predictor=predictor)
        tp = tplan.compile(port, reorder="auto", predictor=predictor,
                           device="cpu")
        assert (tp.chosen, tp.format_name, tp.compile_stats["scoring"],
                tp.predicted) == (p.chosen, p.format_name,
                                  p.compile_stats["scoring"], p.predicted)


def test_callable_strategy_compiles_but_keys_by_its_module():
    """A strategy callable's cache token carries its module path, so the
    port's `repro_torch.reorder.rcm` cannot key as the reference's
    `repro.reorder.rcm` does; the plan is the same all the same."""
    ref = _scrambled_banded(512)
    port = port_csr(ref)
    tk = tplan.PlanCache.key_for(port, reorder=T.rcm)
    rk = rplan.PlanCache.key_for(ref, reorder=R.rcm)
    assert "fn:repro_torch.reorder.strategies.rcm" in tk
    assert "fn:repro.reorder.strategies.rcm" in rk and tk != rk
    tp = tplan.compile(port, reorder=T.rcm, device="cpu")
    p = rplan.compile(ref, reorder=R.rcm, predictor="none")
    assert (tp.format_name, tp.chosen) == (p.format_name, p.chosen)
    assert _same_reordering(p.reordering, tp.reordering)
    with pytest.raises(TypeError, match="unsupported reorder"):
        tplan.compile(port, reorder=3, device="cpu")


# ---------------------------------------------------------------------------
# drivers with reorder=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["fd", "rmat"])
@pytest.mark.parametrize("analytic,kw", [
    ("bfs", {"source": 3}), ("sssp", {"source": 3}),
    ("connected_components", {}), ("bfs", {"source": [1, 5]})])
def test_exact_analytics_under_rcm_match_reference(family, analytic, kw):
    ref = (rg.fd_matrix if family == "fd" else rg.rmat_matrix)(1024, seed=2)
    m, sr, _ = rdrv.analytic_operand(analytic, ref)
    opts = rdrv.plan_options(sr, reorder="rcm")
    tm = tdrv.analytic_operand(analytic, port_csr(ref))[0]
    assert rplan.PlanCache.key_for(m, **opts) == \
        tplan.PlanCache.key_for(tm, **tdrv.plan_options(sr, reorder="rcm"))
    a = rdrv.DRIVERS[analytic](ref, reorder="rcm", **kw)
    b = tdrv.DRIVERS[analytic](port_csr(ref), reorder="rcm", device="cpu",
                               **kw)
    assert (b.n_iters, b.converged, b.history) == \
        (a.n_iters, a.converged, a.history)
    assert np.array_equal(b.values, a.values)
    assert b.plan.summary() == a.plan.summary()
    plain = tdrv.DRIVERS[analytic](port_csr(ref), device="cpu", **kw)
    assert np.array_equal(b.values, plain.values)


@pytest.mark.parametrize("family", ["fd", "rmat", "blocked"])
def test_pagerank_under_rcm_matches_reference(family):
    ref = {"fd": lambda: rg.fd_matrix(1024, seed=2),
           "rmat": lambda: rg.rmat_matrix(1024, seed=2),
           "blocked": _blocked}[family]()
    a = rdrv.pagerank(ref, tol=1e-6, reorder="rcm")
    b = tdrv.pagerank(port_csr(ref), tol=1e-6, reorder="rcm", device="cpu")
    assert (b.n_iters, b.converged) == (a.n_iters, a.converged)
    assert b.plan.format_name == a.plan.format_name
    np.testing.assert_allclose(b.values, a.values, rtol=0, atol=1e-6)


def test_pagerank_on_a_blocked_graph_runs_bell():
    """The blocked graph's PageRank operand analyses as `blocked`, so the
    PageRank plan is BELL in both packages."""
    ref = _blocked(2048, 24, 1)
    a = rdrv.pagerank(ref, tol=1e-6)
    b = tdrv.pagerank(port_csr(ref), tol=1e-6, device="cpu")
    assert a.plan.format_name == b.plan.format_name == "bell"
    assert b.n_iters == a.n_iters
    np.testing.assert_allclose(b.values, a.values, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# per-call ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("container", ["ell", "hyb"])
def test_ops_refuse_non_absorbing_padding(container):
    """(0.0, col 0) padding under min_plus is refused with the
    reference's message; absorbing padding runs and equals the
    reference."""
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 8, 32) * 2
    ref = rf.CSR.from_coo(rows, rng.integers(0, 16, 32),
                          rng.integers(1, 9, 32).astype(np.float32), 16, 16)
    port = port_csr(ref)
    sr = SEMIRINGS["min_plus"]
    x = torch.from_numpy(_int_x(16, seed=4).clip(0))
    cls, fn = (tf.ELL, tops.spmv_ell) if container == "ell" else \
        (tf.HYB, tops.spmv_hyb)
    rcls, rfn = (rf.ELL, rops.spmv_ell) if container == "ell" else \
        (rf.HYB, rops.spmv_hyb)
    from repro.graph.semiring import SEMIRINGS as RS

    with pytest.raises(ValueError, match="fill=semiring.pad_value"):
        fn(cls.from_csr(port, fill=0.0), x, semiring=sr)
    with pytest.raises(ValueError, match="fill=semiring.pad_value"):
        rfn(rcls.from_csr(ref, fill=0.0), jnp.asarray(x.numpy()),
            semiring=RS["min_plus"])
    got = fn(cls.from_csr(port, fill=sr.pad_value), x, semiring=sr)
    want = rfn(rcls.from_csr(ref, fill=sr.pad_value),
               jnp.asarray(x.numpy()), semiring=RS["min_plus"])
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt", ["dia", "bell", "ell", "csr", "csr-seg",
                                 "hyb"])
def test_ops_accept_reordering(fmt):
    """Every per-call wrapper multiplies the reordered operand and
    returns y in the original order, equal to the reference's."""
    ref = _int_valued(_blocked(512, 8, 2) if fmt == "bell"
                      else rg.fd_matrix(256, seed=3))
    r, tr = R.cache_block(ref), T.cache_block(port_csr(ref))
    moved, tmoved = r.apply(ref), tr.apply(port_csr(ref))
    conv = {"csr-seg": "csr"}.get(fmt, fmt)
    c = rplan.convert(moved, conv)
    tc = tplan.convert(tmoved, conv)
    x = _int_x(ref.n_cols, seed=5)
    fn = {"dia": rops.spmv_dia, "bell": rops.spmv_bell,
          "ell": rops.spmv_ell, "csr": rops.spmv_csr,
          "csr-seg": rops.spmv_csr_seg, "hyb": rops.spmv_hyb}[fmt]
    tfn = getattr(tops, fn.__name__)
    want = np.asarray(fn(c, jnp.asarray(x), interpret=True, reordering=r))
    got = tfn(tc, torch.from_numpy(x), reordering=tr).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(r_spmv(ref, jnp.asarray(x))))
