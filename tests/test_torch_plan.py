"""Port vs reference: plan compilation and the plan cache.

For the same matrix and options the port picks the same format, the
same candidate and the same scoring mode, and its cache keys are the
reference's strings.  Entry points default to the card and refuse to
run without one; malformed sharding options are refused (sharded plans
are held to the reference in `test_torch_distributed.py`).  The
scoring itself is held to the reference in `test_torch_scoring.py`.
"""
import numpy as np
import pytest
import torch
from _torch_parity import int_operands, port_csr

import jax.numpy as jnp
from repro import plan as rplan
from repro.core import generators as rg
from repro.graph import drivers as rdrv
from repro_torch import plan as tplan
from repro_torch.core import generators as tg
from repro_torch.graph import drivers as tdrv

ANALYTICS = ("pagerank", "bfs", "sssp", "connected_components")


@pytest.mark.parametrize("family", ["fd", "rmat"])
@pytest.mark.parametrize("n", [1 << 10, 1 << 12])
@pytest.mark.parametrize("analytic", ANALYTICS)
def test_compile_picks_the_reference_format(family, n, analytic):
    """On each analytic's operand: same format_name, chosen candidate and
    scoring mode, and the same cache key for the drivers' options."""
    ref = (rg.fd_matrix if family == "fd" else rg.rmat_matrix)(n)
    m, sr, _ = rdrv.analytic_operand(analytic, ref)
    tm, tsr, _ = tdrv.analytic_operand(analytic, port_csr(ref))
    assert sr == tsr
    opts, topts = rdrv.plan_options(sr), tdrv.plan_options(tsr)
    assert opts == topts
    assert rplan.PlanCache.key_for(m, **opts) == \
        tplan.PlanCache.key_for(tm, **topts)
    p = rplan.compile(m, **opts)
    tp = tplan.PlanCache().get_or_compile(tm, **dict(topts, device="cpu"))
    assert (tp.format_name, tp.chosen, tp.compile_stats["scoring"]) == \
        (p.format_name, p.chosen, p.compile_stats["scoring"])
    assert set(tp.compile_stats) == set(p.compile_stats)
    assert tp.fingerprint == p.fingerprint
    assert tp.summary() == p.summary()


def test_main_path_formats_at_test_sizes():
    """The table of the slice: FD plus-times -> dia, FD semirings -> ell,
    R-MAT -> hyb."""
    fd = tg.fd_matrix(1 << 10, device="cpu")
    rm = tg.rmat_matrix(1 << 10, device="cpu")
    assert tplan.compile(fd, device="cpu").format_name == "dia"
    assert tplan.compile(fd, semiring="or_and",
                         device="cpu").format_name == "ell"
    for sr in ("plus_times", "min_plus", "or_and"):
        assert tplan.compile(rm, semiring=sr,
                             device="cpu").format_name == "hyb"


@pytest.mark.parametrize("fmt", ["dia", "ell", "csr", "csr-seg", "hyb"])
def test_forced_format_matches_reference_execute(fmt):
    ref_csr, x = int_operands("rmat", 256, 4, "plus_times")
    want = np.asarray(rplan.compile(ref_csr, format=fmt, reorder="none",
                                    predictor="none").execute(
        jnp.asarray(x), interpret=True))
    tp = tplan.compile(port_csr(ref_csr), format=fmt, reorder="none",
                       predictor="none", device="cpu")
    assert tp.report is None and "analyze_s" not in tp.compile_stats
    assert np.array_equal(tp.execute(x).numpy(), want)
    # the plain container path computes the same integer-valued product
    plain = tplan.compile(port_csr(ref_csr), format=fmt, use_pallas=False,
                          reorder="none", predictor="none", device="cpu")
    assert plain.prep is None
    assert np.array_equal(plain.execute(x).numpy(), want)


@pytest.mark.parametrize("sr_name", ["plus_times", "min_plus", "or_and"])
@pytest.mark.parametrize("family", ["fd", "rmat"])
def test_execute_many_matches_reference_and_execute(sr_name, family):
    ref_csr, _ = int_operands(family, 256, 6, sr_name)
    X = np.stack([int_operands(family, 256, s, sr_name)[1]
                  for s in (7, 8, 9)])
    p = rplan.compile(ref_csr, reorder="none", predictor="none",
                      semiring=sr_name)
    tp = tplan.compile(port_csr(ref_csr), reorder="none", predictor="none",
                       semiring=sr_name, device="cpu")
    want = np.asarray(p.execute_many(jnp.asarray(X)))
    got = tp.execute_many(X).numpy()
    assert got.shape == (3, 256) and np.array_equal(got, want)
    for k in range(3):
        assert np.array_equal(tp.execute(X[k]).numpy(), got[k])
    with pytest.raises(ValueError):
        tp.execute_many(X[0])


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("family,fmt,reorder", [
    ("rmat", None, "none"), ("fd", "csr", "none"), ("rmat", "csr-seg",
                                                   "none"),
    ("fd", "csr", "rcm"), ("rmat", "bell", "none")])
def test_execute_many_rows_equal_execute(family, fmt, reorder, use_pallas):
    """Real-valued X: every row of `execute_many` equals `execute` of
    that row bit for bit, and a second call equals the first -- on the
    kernel path (one execute per row) and on the oracle path (ordered
    sums)."""
    m = (tg.rmat_matrix if family == "rmat" else tg.fd_matrix)(
        256, device="cpu")
    p = tplan.compile(m, format=fmt, reorder=reorder,
                      use_pallas=use_pallas, device="cpu")
    X = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (4, 256)).astype(np.float32))
    Y = p.execute_many(X)
    assert Y.shape == (4, 256) and torch.equal(p.execute_many(X), Y)
    for k in range(4):
        assert torch.equal(p.execute(X[k]), Y[k])
    assert p.execute_many(X[:0]).shape == (0, 256)


@pytest.mark.parametrize("shape", [(1000,), (3, 1000)])
def test_ordered_sum_is_a_segment_sum_in_a_fixed_order(shape):
    """`Semiring.segment` under plus-times: the scatter sum on integers,
    within rounding on reals, the same for a vector alone and as a batch
    row, empty segments +0."""
    from repro_torch.graph.semiring import PLUS_TIMES, ordered_sum

    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, 80, 1000))
    idx[idx == 9] = 10
    ints = torch.from_numpy(rng.integers(-8, 9, shape).astype(np.float32))
    want = torch.zeros(shape[:-1] + (90,)).scatter_add(
        -1, idx.expand(shape), ints)
    got = PLUS_TIMES.segment(ints, idx, 90)
    assert torch.equal(got, want) and bool((got[..., 9] == 0).all())
    real = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    got = ordered_sum(real, idx, 90)
    torch.testing.assert_close(got, torch.zeros(shape[:-1] + (90,))
                               .scatter_add(-1, idx.expand(shape), real),
                               rtol=1e-5, atol=1e-5)
    if len(shape) == 2:
        for k in range(shape[0]):
            assert torch.equal(ordered_sum(real[k], idx, 90), got[k])


def test_segment_runs_are_built_once_per_index():
    """The run table is kept for the index tensor that made it, rebuilt
    when the index changes in place (with the sums that follow), and
    dropped with the index."""
    import gc

    from repro_torch.graph import semiring as tsr

    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 50, 400))
    ints = torch.from_numpy(rng.integers(-8, 9, 400).astype(np.float32))
    runs = tsr.segment_runs(idx, 60)
    assert tsr.segment_runs(idx, 60) is runs
    assert tsr.segment_runs(idx, 61) is not runs
    assert sum(g.numel() for _, g in runs) < 2 * 400
    idx[:100] = 55
    assert tsr.segment_runs(idx, 60) is not runs
    want = torch.zeros(60).scatter_add(0, idx, ints)
    assert torch.equal(tsr.ordered_sum(ints, idx, 60), want)
    n = len(tsr._CACHE)
    del idx, runs
    gc.collect()
    assert len(tsr._CACHE) == n - 2


@pytest.mark.parametrize("family,fmt", [("fd", "csr"), ("rmat", "hyb")])
def test_oracle_plan_repeats_its_sums_from_the_kept_runs(family, fmt):
    """A `use_pallas=False` plan keeps one run table for its container,
    and every call after the first sums through it to the same bits."""
    from repro_torch.graph import semiring as tsr

    m = (tg.rmat_matrix if family == "rmat" else tg.fd_matrix)(
        256, device="cpu")
    p = tplan.compile(m, format=fmt, use_pallas=False, device="cpu")
    x = torch.from_numpy(np.random.default_rng(6).uniform(
        -1, 1, 256).astype(np.float32))
    y = p.execute(x)
    n = len(tsr._CACHE)
    assert all(torch.equal(p.execute(x), y) for _ in range(3))
    assert len(tsr._CACHE) == n


def test_power_iteration_matches_reference():
    ref = rg.fd_matrix(256, seed=1)
    x0 = np.random.default_rng(0).uniform(0.5, 1.5, 256).astype(np.float32)
    lam, v = rplan.compile(ref, reorder="none",
                           predictor="none").power_iteration(
        jnp.asarray(x0), n_iters=8)
    tlam, tv = tplan.compile(port_csr(ref), reorder="none", predictor="none",
                             device="cpu").power_iteration(x0, n_iters=8)
    np.testing.assert_allclose(float(tlam), float(lam), rtol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(v), rtol=1e-5,
                               atol=1e-7)


def test_default_device_is_the_card_and_refuses_without_one(monkeypatch):
    """device=None means CUDA; with no card every entry point raises a
    RuntimeError that names device='cpu', before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = tg.fd_matrix(64, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplan.compile(m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.fd_matrix(64)
    for name, kw in (("pagerank", {}), ("bfs", {"source": 0}),
                     ("sssp", {"source": 0}), ("connected_components", {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdrv.DRIVERS[name](m, **kw)


def test_plan_refuses_x_on_another_device():
    tp = tplan.compile(tg.fd_matrix(64, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="lies on"):
        tp.execute(torch.zeros(64, device="meta"))


@pytest.mark.parametrize("opts,item", [
    ({"mesh": object()}, "RowMesh"), ({"partition": object()}, "RowPartition")])
def test_options_outside_the_slice_raise(opts, item):
    """Sharded plans are ported (`mesh=`, `partition=`); a mesh that is
    not a `RowMesh`, or a partition that is not a `RowPartition`, is
    refused."""
    from repro_torch.distributed import row_mesh

    m = tg.fd_matrix(64, device="cpu")
    if "partition" in opts:
        opts = dict(opts, mesh=row_mesh(["cpu"] * 2))
    with pytest.raises(TypeError, match=item):
        tplan.compile(m, device="cpu", **opts)


def test_bad_options_raise_value_errors():
    m = tg.fd_matrix(64, device="cpu")
    with pytest.raises(ValueError, match="requires a format"):
        tplan.compile(m, semiring="min_plus", format="dia", device="cpu")
    with pytest.raises(TypeError, match="interpret"):
        tplan.compile(m, interpret=True, device="cpu")
    with pytest.raises(ValueError, match="unknown format"):
        tplan.compile(m, format="coo", device="cpu")


def test_plan_cache_lru_and_stats():
    cache = tplan.PlanCache(max_plans=2)
    mats = [tg.fd_matrix(64, seed=s, device="cpu") for s in range(3)]
    opts = dict(device="cpu")
    a = cache.get_or_compile(mats[0], **opts)
    assert cache.get_or_compile(mats[0], **opts) is a
    key0 = cache.key_for(mats[0], **opts)
    assert cache.contains(key0) and key0.endswith("device='cpu'")
    cache.get_or_compile(mats[1], **opts)
    cache.get_or_compile(mats[2], **opts)            # evicts mats[0]
    assert not cache.contains(key0) and len(cache) == 2
    st = cache.stats()
    assert (st["hits"], st["misses"], st["evictions"], st["compiles"]) == \
        (1, 3, 1, 3)
    assert st["hit_rate"] == 0.25
    cache.clear()
    assert len(cache) == 0 and cache.stats()["compiles"] == 0


def test_cache_key_tokens_match_reference_for_callables_and_arrays():
    m = rg.fd_matrix(64)
    tm = port_csr(m)
    extra = {"tag": np.arange(4), "fn": abs}
    assert rplan.PlanCache.key_for(m, **extra) == \
        tplan.PlanCache.key_for(tm, **extra)
