"""Port vs reference: the four blocking graph drivers end to end.

Same graph (FD and R-MAT at 2^10), same seeds.  BFS, SSSP and connected
components must be equal, values and iteration counts.  PageRank must
take the same number of iterations and agree within 1e-6 absolute (the
values sum to 1); it runs at tol=1e-6 because at 1e-8 the float32
residual sits in rounding noise, and the two packages' summation
orders then stop it on different iterations.
"""
import numpy as np
import pytest
from _torch_parity import port_csr

from repro.core import generators as rg
from repro.graph import drivers as rdrv
from repro_torch.core.formats import CSR
from repro_torch.graph import drivers as tdrv

N = 1 << 10
PR_TOL = 1e-6
PR_ATOL = 1e-6


def _graph(family):
    ref = (rg.fd_matrix if family == "fd" else rg.rmat_matrix)(N, seed=2)
    return ref, port_csr(ref)


def _r0():
    return np.random.default_rng(5).uniform(0.5, 1.5, N).astype(np.float32)


@pytest.mark.parametrize("family", ["fd", "rmat"])
@pytest.mark.parametrize("use_r0", [True, False])
def test_pagerank_matches_reference(family, use_r0):
    ref, port = _graph(family)
    kw = dict(tol=PR_TOL, r0=_r0() if use_r0 else None)
    a = rdrv.pagerank(ref, **kw)
    b = tdrv.pagerank(port, device="cpu", **kw)
    assert b.n_iters == a.n_iters and b.converged == a.converged
    np.testing.assert_allclose(b.values, a.values, rtol=0, atol=PR_ATOL)
    np.testing.assert_allclose(b.values.sum(), 1.0, atol=1e-5)
    assert b.plan.format_name == a.plan.format_name


@pytest.mark.parametrize("family", ["fd", "rmat"])
@pytest.mark.parametrize("analytic,kw", [
    ("bfs", {"source": 3}), ("sssp", {"source": 3}),
    ("connected_components", {}), ("bfs", {"source": [1, 5, 5]})])
def test_exact_analytics_match_reference(family, analytic, kw):
    ref, port = _graph(family)
    a = rdrv.DRIVERS[analytic](ref, **kw)
    b = tdrv.DRIVERS[analytic](port, device="cpu", **kw)
    assert (b.n_iters, b.converged) == (a.n_iters, a.converged)
    assert b.values.dtype == np.float32 and b.values.shape == \
        a.values.shape
    assert np.array_equal(b.values, a.values)
    assert b.history == a.history
    assert b.plan.format_name == a.plan.format_name


def test_max_iters_caps_a_run():
    ref, port = _graph("fd")
    a = rdrv.sssp(ref, 0, max_iters=5)
    b = tdrv.sssp(port, 0, max_iters=5, device="cpu")
    assert b.n_iters == a.n_iters == 5 and not b.converged
    assert np.array_equal(b.values, a.values)


def test_plain_path_matches_kernel_path():
    """`use_pallas=False` (the container oracle) and the prepared-layout
    path give equal BFS/SSSP/CC results and the same iteration count."""
    _, port = _graph("rmat")
    for analytic, kw in (("bfs", {"source": 0}), ("sssp", {"source": 0}),
                         ("connected_components", {})):
        a = tdrv.DRIVERS[analytic](port, device="cpu", **kw)
        b = tdrv.DRIVERS[analytic](port, device="cpu", use_pallas=False,
                                   **kw)
        assert a.n_iters == b.n_iters
        assert np.array_equal(a.values, b.values)


def _empty(n=16):
    z = np.array([], dtype=np.int64)
    return CSR.from_coo(z, z, np.array([], np.float32), n, n, device="cpu")


def test_empty_graph_edge_cases():
    g = _empty()
    b = tdrv.bfs(g, 0, device="cpu")
    assert b.n_iters == 1 and b.values[0] == 0 and np.isinf(b.values[1:]).all()
    s = tdrv.sssp(g, 2, device="cpu")
    assert s.values[2] == 0 and np.isinf(np.delete(s.values, 2)).all()
    c = tdrv.connected_components(g, device="cpu")
    assert np.array_equal(c.values, np.arange(16, dtype=np.float32))
    p = tdrv.pagerank(g, device="cpu")
    np.testing.assert_allclose(p.values, np.full(16, 1 / 16), rtol=1e-6)
    e = tdrv.bfs(g, [], device="cpu")
    assert e.values.shape == (0, 16) and e.n_iters == 0


def test_sources_are_validated():
    _, port = _graph("fd")
    with pytest.raises(ValueError, match="out of range"):
        tdrv.bfs(port, N, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tdrv.sssp(port, -1, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tdrv.bfs(port, N, reorder="rcm", device="cpu")


def test_drivers_reuse_the_cached_plan():
    from repro_torch.plan import PlanCache

    _, port = _graph("fd")
    cache = PlanCache()
    tdrv.bfs(port, 0, plan_cache=cache, device="cpu")
    tdrv.bfs(port, 7, plan_cache=cache, device="cpu")
    assert cache.stats()["compiles"] == 1 and cache.stats()["hits"] == 1


def test_steppers_keep_state_on_the_plan_device():
    _, port = _graph("rmat")
    r = tdrv.sssp(port, 0, device="cpu")
    st = tdrv.make_stepper("sssp", r.plan, {}, sources=[0])
    assert st.frontier().device == r.plan.device
    with pytest.raises(ValueError, match="unknown analytic"):
        tdrv.make_stepper("katz", r.plan, {})
