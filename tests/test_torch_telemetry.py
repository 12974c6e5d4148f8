"""Port vs reference: the cache and thread simulators behind the
compiler's scoring -- the analytic Che model, the trace-driven
hierarchy with the §V mechanisms, the address traces of every format,
the topdown accounting and the multithreaded contended-LLC replay.

All of it is host-side Python and numpy in both packages and models the
reference's Sandy Bridge machine.  The same matrices (the reference's
CSRs, handed to the port through `port_csr`) go through both; every
float is compared with `==` and every counter and trace exactly.
Replays stay at <= 2^12 rows (one Python call per address).
"""
import dataclasses

import numpy as np
import pytest
from _torch_parity import port_csr

from repro.core import cache_model as rcmod
from repro.core import formats as rfmt
from repro.core import generators as rg
from repro.core import partition as rpart
from repro.core import structure as rstruct
from repro.parallel import ParallelSpec as RSpec
from repro.parallel import simulate_parallel as r_simulate
from repro.telemetry import events as rev
from repro.telemetry import hierarchy as rh
from repro.telemetry import topdown as rtd
from repro_torch.core import cache_model as tcmod
from repro_torch.core import formats as tfmt
from repro_torch.core import partition as tpart
from repro_torch.core import structure as tstruct
from repro_torch.device import to_numpy
from repro_torch.parallel import ParallelSpec as TSpec
from repro_torch.parallel import simulate_parallel as t_simulate
from repro_torch.telemetry import events as tev
from repro_torch.telemetry import hierarchy as th
from repro_torch.telemetry import topdown as ttd

RSB, TSB = rcmod.SANDY_BRIDGE, tcmod.SANDY_BRIDGE
FAMILIES = {
    "fd": rg.fd_matrix,
    "rmat": rg.rmat_matrix,
    "uniform": rg.uniform_random_matrix,
    "banded": lambda n: rg.banded_matrix(n, max(8, n // 32)),
}


def _fields(obj):
    """A dataclass as a tuple, nested dataclasses (TopdownStages) as
    their own tuples, so two packages' records compare with `==`."""
    return tuple(_fields(v) if dataclasses.is_dataclass(v) else
                 tuple(_fields(x) if dataclasses.is_dataclass(x) else x
                       for x in v) if isinstance(v, tuple) else v
                 for v in (getattr(obj, f.name)
                           for f in dataclasses.fields(obj)))


def test_machine_model_matches_reference():
    assert dataclasses.asdict(TSB) == dataclasses.asdict(RSB)
    assert [f.name for f in dataclasses.fields(tcmod.CacheMetrics)] == \
        [f.name for f in dataclasses.fields(rcmod.CacheMetrics)]
    for parallel in (False, True):
        for nnz_per_row in (9.0, 8.0):
            assert tcmod.table1_capacity(TSB, nnz_per_row, parallel) == \
                rcmod.table1_capacity(RSB, nnz_per_row, parallel)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("log2n", [10, 12, 14])
@pytest.mark.parametrize("threads", [1, 4, 16])
def test_analytic_metrics_are_bit_equal(family, log2n, threads):
    ref = FAMILIES[family](1 << log2n)
    port = port_csr(ref)
    want = rcmod.analytic_metrics(ref, RSB, threads=threads)
    got = tcmod.analytic_metrics(port, TSB, threads=threads)
    assert _fields(got) == _fields(want)
    assert np.array_equal(tcmod.x_line_popularity(port, TSB),
                          rcmod.x_line_popularity(ref, RSB))
    rp, tp = rcmod.profile_of(ref, RSB), tcmod.profile_of(port, TSB)
    assert np.array_equal(tp.line_counts, rp.line_counts)
    assert (tp.stream_servable, tp.n_band_groups, tp.nnz) == \
        (rp.stream_servable, rp.n_band_groups, rp.nnz)


@pytest.mark.parametrize("log2n", [11, 16, 20])
def test_synthetic_profiles_are_bit_equal(log2n):
    n = 1 << log2n
    for make in ("profile_fd", "profile_rmat"):
        rp = getattr(rcmod, make)(n, machine=RSB)
        tp = getattr(tcmod, make)(n, machine=TSB)
        assert tp.line_counts.tobytes() == rp.line_counts.tobytes()
        assert (tp.nnz, tp.stream_servable, tp.n_band_groups) == \
            (rp.nnz, rp.stream_servable, rp.n_band_groups)
        for threads in (1, 8, 32):
            assert _fields(tcmod.analytic_metrics_from_profile(
                tp, TSB, threads=threads)) == _fields(
                rcmod.analytic_metrics_from_profile(rp, RSB,
                                                    threads=threads))
    assert _fields(tcmod.analytic_metrics_from_profile(
        tcmod.profile_fd(n), structured_frac=0.5)) == _fields(
        rcmod.analytic_metrics_from_profile(rcmod.profile_fd(n),
                                            structured_frac=0.5))


@pytest.mark.parametrize("family", ["fd", "rmat"])
@pytest.mark.parametrize("log2n", [10, 12])
def test_simulate_exact_matches_reference(family, log2n):
    ref = FAMILIES[family](1 << log2n)
    assert tcmod.simulate_exact(port_csr(ref), TSB) == \
        rcmod.simulate_exact(ref, RSB)


SPECS = [dict(),
         dict(victim_entries=8, l2_bytes=8 * 1024),
         dict(miss_entries=16, ways=2, l2_bytes=4 * 1024),
         dict(stream_buffers=4, stream_depth=2, l2_bytes=16 * 1024,
              l3_bytes=64 * 1024, l3_ways=8),
         dict(victim_entries=4, miss_entries=4, stream_buffers=2,
              ways=8, l2_bytes=8 * 1024, l3_bytes=32 * 1024,
              prefetcher=False)]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "+".join(s) or "base")
@pytest.mark.parametrize("family", ["rmat", "uniform"])
def test_hierarchy_counters_match_reference(spec, family):
    """Every event counter of a two-sweep replay, with the prefetcher,
    victim cache, miss cache and stream buffers in turn and together."""
    ref = FAMILIES[family](1 << 11)
    rspec, tspec = rh.HierarchySpec(**spec), th.HierarchySpec(**spec)
    assert tspec.label() == rspec.label()
    want = rspec.instantiate(RSB).run_spmv(ref, RSB, sweeps=2)
    got = tspec.instantiate(TSB).run_spmv(port_csr(ref), TSB, sweeps=2)
    assert got.as_dict() == want.as_dict()
    assert got.validate() == []
    served = [got[event] for key, event in (
        ("victim_entries", tev.VICTIM_HIT), ("miss_entries",
                                             tev.MISS_CACHE_HIT),
        ("stream_buffers", tev.STREAM_HIT)) if spec.get(key)]
    assert not served or max(served) > 0   # the mechanisms serve misses
    # the topdown roll-up of those counters
    nnz = ref.nnz
    assert ttd.stage_cycles(got, TSB, nnz).as_dict() == \
        rtd.stage_cycles(want, RSB, nnz).as_dict()
    assert ttd.topdown_tree(got, TSB, nnz).flatten() == \
        rtd.topdown_tree(want, RSB, nnz).flatten()
    assert ttd.topdown_summary(got, TSB, nnz).as_dict() == \
        rtd.topdown_summary(want, RSB, nnz).as_dict()
    assert ttd.topdown_summary(got, TSB, nnz).bound() == \
        rtd.topdown_summary(want, RSB, nnz).bound()
    assert ttd.topdown_tree(got, TSB, nnz).render() == \
        rtd.topdown_tree(want, RSB, nnz).render()


def test_cache_primitives_match_reference():
    rng = np.random.default_rng(0)
    lines = rng.integers(0, 96, 4000).tolist()
    for ways in (None, 4):
        a, b = rh.SetAssocCache(32, ways), th.SetAssocCache(32, ways)
        trace_a = [(a.lookup(ln), a.insert(ln, prefetched=ln % 3 == 0))
                   for ln in lines]
        trace_b = [(b.lookup(ln), b.insert(ln, prefetched=ln % 3 == 0))
                   for ln in lines]
        assert trace_a == trace_b
        assert a.resident_lines() == b.resident_lines()
    pa, pb = rh.SequentialPrefetcher(4, 3), th.SequentialPrefetcher(4, 3)
    seq = [int(v) for v in np.cumsum(rng.integers(0, 3, 2000))]
    assert [pa.observe(v) for v in seq] == [pb.observe(v) for v in seq]
    for cls in ("VictimCache", "MissCache", "StreamBuffers"):
        ma, mb = getattr(rh, cls)(4), getattr(th, cls)(4)
        ca, cb = rev.EventCounters(), tev.EventCounters()
        out_a = [(ma.probe(v, ca), ma.on_evict(v + 1)) for v in seq[:500]]
        out_b = [(mb.probe(v, cb), mb.on_evict(v + 1)) for v in seq[:500]]
        assert out_a == out_b and ca.as_dict() == cb.as_dict()


def test_event_registry_matches_reference():
    assert tev.known_events() == rev.known_events()
    c = tev.EventCounters({tev.ACCESS: 3})
    c.inc(tev.L2_DEMAND_MISS, 2)
    assert c == tev.EventCounters({tev.ACCESS: 3, tev.L2_DEMAND_MISS: 2,
                                   tev.VICTIM_HIT: 0})
    assert c.rate(tev.L2_DEMAND_MISS, tev.ACCESS) == 2 / 3
    assert c.merge(c).as_dict() == {tev.ACCESS: 6, tev.L2_DEMAND_MISS: 4}
    assert repr(c) == repr(rev.EventCounters(c.as_dict()))
    assert tev.EventCounters({"NOT_AN_EVENT": 1}).validate() == \
        ["NOT_AN_EVENT"]
    assert tev.describe(tev.STREAM_FILL) == rev.describe(rev.STREAM_FILL)


def _container(mod, fmt, csr):
    return {"dia": mod.DIA, "ell": mod.ELL, "bell": mod.BELL,
            "hyb": mod.HYB}[fmt].from_csr(csr) if fmt in (
        "dia", "ell", "bell", "hyb") else csr


@pytest.mark.parametrize("fmt", ["dia", "bell", "ell", "csr", "csr-seg",
                                 "hyb"])
@pytest.mark.parametrize("family", ["fd", "rmat", "uniform"])
def test_format_address_traces_match_reference(fmt, family):
    ref = FAMILIES[family](1 << 10)
    port = port_csr(ref)
    rc, tc = _container(rfmt, fmt, ref), _container(tfmt, fmt, port)
    want = rh.format_address_trace(ref, fmt, RSB, container=rc)
    got = th.format_address_trace(port, fmt, TSB, container=tc)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    # without a container the HYB trace is rebuilt from the CSR
    assert np.array_equal(th.format_address_trace(port, fmt, TSB),
                          rh.format_address_trace(ref, fmt, RSB))


@pytest.mark.parametrize("family", ["rmat", "uniform"])
def test_hyb_trace_walks_the_column_sorted_heavy_stream(family):
    """The heavy stream's x gathers ascend (the container's column
    order, the CPU execution the paper models), with and without the
    light counts, as in the reference."""
    ref = FAMILIES[family](1 << 10)
    rh_c = rfmt.HYB.from_csr(ref, threshold=4)
    th_c = tfmt.HYB.from_csr(port_csr(ref), threshold=4)
    assert np.array_equal(to_numpy(th_c.hcols), np.asarray(rh_c.hcols))
    for counts in (None, np.minimum(ref.row_lengths(), 4)):
        want = rh.hyb_address_trace(rh_c, RSB, light_counts=counts)
        got = th.hyb_address_trace(th_c, TSB, light_counts=counts)
        assert np.array_equal(got, want)
    heavy_x = got[-(4 * th_c.heavy_nnz + len(np.unique(to_numpy(
        th_c.hrows)))):][3:4 * th_c.heavy_nnz:4]
    assert np.all(np.diff(heavy_x) >= 0)


@pytest.mark.parametrize("fmt", ["csr", "hyb"])
@pytest.mark.parametrize("k", [0, 1, 37])
def test_overlay_address_trace_matches_reference(fmt, k):
    ref = rg.rmat_matrix(1 << 10, seed=5)
    port = port_csr(ref)
    rng = np.random.default_rng(k)
    rows, cols = rng.integers(0, 1 << 10, k), rng.integers(0, 1 << 10, k)
    want = rh.overlay_address_trace(ref, fmt, rows, cols, RSB,
                                    container=_container(rfmt, fmt, ref))
    got = th.overlay_address_trace(port, fmt, rows, cols, TSB,
                                   container=_container(tfmt, fmt, port))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("family", ["fd", "rmat", "banded"])
@pytest.mark.parametrize("threads", [1, 2, 4])
@pytest.mark.parametrize("spec", [
    dict(), dict(l2_bytes=16 * 1024, llc_bytes=64 * 1024),
    dict(l1_bytes=4 * 1024, victim_entries=4, stream_buffers=2,
         queueing=False)], ids=["machine", "scaled", "l1+mech"])
def test_simulate_parallel_metrics_match_reference(family, threads, spec):
    """`ParallelMetrics` (stages, per-thread tuples, gflops_est) `==`
    the reference's at 1, 2 and 4 threads, under the row partition the
    compiler's replay oracle uses."""
    ref = FAMILIES[family](1 << 10)
    port = port_csr(ref)
    rpa = rpart.rowblock_balanced(ref, threads)
    tpa = tpart.rowblock_balanced(port, threads)
    assert np.array_equal(tpa.starts, rpa.starts)
    rrun, rm = r_simulate(ref, rpa, RSB, RSpec(**spec), sweeps=2)
    trun, tm = t_simulate(port, tpa, TSB, TSpec(**spec), sweeps=2)
    assert _fields(tm) == _fields(rm)
    assert tm.gflops_est() == rm.gflops_est() and tm.bound() == rm.bound()
    assert (tm.l2_mpki_mean, tm.l2_mpki_max) == (rm.l2_mpki_mean,
                                                 rm.l2_mpki_max)
    assert [c.as_dict() for c in trun.counters] == \
        [c.as_dict() for c in rrun.counters]
    assert np.array_equal(trun.pf_enabled, rrun.pf_enabled)
    assert TSpec(**spec).label() == RSpec(**spec).label()


def test_nnz_partitioned_replay_matches_reference():
    from repro.parallel import engine as reng
    from repro_torch.parallel import engine as teng

    ref = rg.rmat_matrix(1 << 10, seed=2)
    port = port_csr(ref)
    for parts in (1, 3, 4):
        rp, tp = rpart.nnz_split(ref, parts), tpart.nnz_split(port, parts)
        assert np.array_equal(tp.cuts, rp.cuts)
        rt = reng.nnz_partitioned_traces(ref, rp, RSB)
        tt = teng.nnz_partitioned_traces(port, tp, TSB)
        assert len(tt) == len(rt) and all(
            np.array_equal(a, b) for a, b in zip(tt, rt))
        assert np.array_equal(np.concatenate(tt),
                              th.spmv_address_trace(port, TSB))
        rrun = reng.replay_parallel(rt, RSB, RSpec(), sweeps=1)
        trun = teng.replay_parallel(tt, TSB, TSpec(), sweeps=1)
        assert [c.as_dict() for c in trun.counters] == \
            [c.as_dict() for c in rrun.counters]


@pytest.mark.parametrize("family", ["fd", "rmat", "uniform"])
def test_partitions_match_reference(family):
    ref = FAMILIES[family](1 << 10)
    port = port_csr(ref)
    for parts in (1, 3, 8, 5000):
        a, b = rpart.rowblock_equal(ref, parts), tpart.rowblock_equal(
            port, parts)
        assert np.array_equal(b.starts, a.starts)
        assert np.array_equal(b.nnz_per_part, a.nnz_per_part)
        assert b.imbalance() == a.imbalance() and b.n_parts == a.n_parts
        a, b = rpart.rowblock_balanced(ref, parts), \
            tpart.rowblock_balanced(port, parts)
        assert np.array_equal(b.starts, a.starts)
        a, b = rpart.nnz_split(ref, parts), tpart.nnz_split(port, parts)
        assert np.array_equal(b.nnz_per_part, a.nnz_per_part)
        assert b.imbalance() == a.imbalance()
    for rs, ts in zip(rpart.col_stripes(ref, 3), tpart.col_stripes(port, 3)):
        assert rs.shape == ts.shape
        assert np.array_equal(np.asarray(rs.indices), to_numpy(ts.indices))
        assert np.array_equal(np.asarray(rs.indptr), to_numpy(ts.indptr))
        assert np.array_equal(np.asarray(rs.data), to_numpy(ts.data))
    (ra, rperm), (ta, tperm) = rpart.sort_rows_by_nnz(ref), \
        tpart.sort_rows_by_nnz(port)
    assert np.array_equal(tperm, rperm)
    assert np.array_equal(to_numpy(ta.indices), np.asarray(ra.indices))


@pytest.mark.parametrize("family", ["fd", "rmat"])
def test_access_stream_and_reuse_distances_match_reference(family):
    ref = FAMILIES[family](1 << 10)
    port = port_csr(ref)
    stream = tstruct.x_access_stream(port)
    assert stream.dtype == np.int64
    assert np.array_equal(stream, rstruct.x_access_stream(ref))
    lines = stream // 8
    assert np.array_equal(tstruct.reuse_distance_histogram(lines),
                          rstruct.reuse_distance_histogram(lines))
