"""Port vs reference: the sweep reports (`repro_torch.telemetry.report`).

Each report renders the same text as the reference's on the same points:
the reference's sweep points, carried into the port through their
payloads (`decode_point` of `encode_point`), and the port's own points
where they are the reference's bytes (mech and scaling grids).
"""
import pytest

from repro.reorder import STRATEGIES as R_STRATEGIES
from repro.telemetry import report as rrep
from repro.telemetry import runner as rrun
from repro.telemetry import sweep as rsw
from repro.telemetry.hierarchy import HierarchySpec as RSpec
from repro_torch.reorder import STRATEGIES as T_STRATEGIES
from repro_torch.telemetry import report as trep
from repro_torch.telemetry import runner as trun
from repro_torch.telemetry import sweep as tsw


def _carried(points):
    return [trun.decode_point(rrun.encode_point(p)) for p in points]


@pytest.fixture(scope="module")
def mech():
    ref = rsw.run_sweep(log2ns=(8, 10), threads_list=(1, 2))
    port = tsw.run_sweep(log2ns=(8, 10), threads_list=(1, 2), device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def reordered():
    ref = rsw.reorder_sweep(log2ns=(8,), reorderings={
        "none": None, "rcm": R_STRATEGIES["rcm"],
        "degree-sort": R_STRATEGIES["degree-sort"]})
    port = tsw.reorder_sweep(log2ns=(8,), reorderings={
        "none": None, "rcm": T_STRATEGIES["rcm"],
        "degree-sort": T_STRATEGIES["degree-sort"]}, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def scaling():
    out = {}
    for part in ("balanced", "merge"):
        kw = dict(log2ns=(8,), threads_list=(1, 2, 4), partition=part,
                  reorderings=None)
        out[part] = (rsw.scaling_sweep(**kw),
                     tsw.scaling_sweep(device="cpu", **kw))
    kw = dict(log2ns=(8,), threads_list=(1, 2, 4), partition="balanced")
    out["rcm"] = (
        rsw.scaling_sweep(reorderings={"none": None,
                                       "rcm": R_STRATEGIES["rcm"]}, **kw),
        tsw.scaling_sweep(reorderings={"none": None,
                                       "rcm": T_STRATEGIES["rcm"]},
                          device="cpu", **kw))
    return out


@pytest.fixture(scope="module")
def graph():
    return rsw.graph_sweep(log2ns=(8,), spec=RSpec(l2_bytes=16384,
                                                   l3_bytes=65536),
                           max_iters=128)


MECH_REPORTS = ["to_csv", "to_json", "to_markdown", "gap_report"]


@pytest.mark.parametrize("name", MECH_REPORTS)
def test_mech_reports(name, mech):
    ref, port = mech
    want = getattr(rrep, name)(ref)
    assert getattr(trep, name)(_carried(ref)) == want
    assert getattr(trep, name)(port) == want


@pytest.mark.parametrize("metric", ["l2_mpki", "l3_mpki"])
def test_reorder_gap_report(metric, reordered):
    ref, port = reordered
    want = rrep.reorder_gap_report(ref, metric=metric)
    assert trep.reorder_gap_report(_carried(ref), metric=metric) == want
    assert trep.reorder_gap_report(port, metric=metric) == want
    assert "rcm" in want and "degree-sort" in want


@pytest.mark.parametrize("name,grid", [
    ("scaling_report", "balanced"), ("scaling_report", "merge"),
    ("scaling_gap_report", "rcm"), ("scaling_gap_report", "balanced")])
def test_scaling_reports(name, grid, scaling):
    ref, port = scaling[grid]
    want = getattr(rrep, name)(ref)
    assert getattr(trep, name)(_carried(ref)) == want
    assert getattr(trep, name)(port) == want


def test_partition_gap_report(scaling):
    ref = scaling["balanced"][0] + scaling["merge"][0]
    port = scaling["balanced"][1] + scaling["merge"][1]
    want = rrep.partition_gap_report(ref)
    assert trep.partition_gap_report(_carried(ref)) == want
    assert trep.partition_gap_report(port) == want
    assert len(want.splitlines()) == 2 + 2 * 2


@pytest.mark.parametrize("name", ["graph_report", "graph_gap_report"])
def test_graph_reports(name, graph):
    want = getattr(rrep, name)(graph)
    assert getattr(trep, name)(_carried(graph)) == want


@pytest.mark.parametrize("before", [False, True])
def test_plan_cache_report(before):
    from repro_torch.plan import PlanCache

    stats = dict(PlanCache().stats(), plans=3, hits=7, misses=2,
                 compiles=2, compile_s=0.5, oracle_compiles=1,
                 oracle_compile_s=0.4, overlays=1)
    prev = dict(stats, hits=3, misses=1, compiles=1, compile_s=0.2) \
        if before else None
    for title in ("plan cache", "serve"):
        assert trep.plan_cache_report(stats, before=prev, title=title) == \
            rrep.plan_cache_report(stats, before=prev, title=title)
    assert trep.plan_cache_report({}) == rrep.plan_cache_report({})
