"""Port vs reference: the analytics serving engine (`serve_graph`).

Every scenario of `tests/test_serve_graph.py` and the engine half of
`tests/test_streaming.py` runs on both packages with the same graphs
(the reference's CSRs, handed to the port through `port_csr`) and the
same request trace: `repro` with its Pallas kernels in interpret mode,
`repro_torch` on device="cpu".  Schedules, preemption logs, mutation
actions and counters must be identical; BFS, SSSP and connected
components values equal; PageRank the same iteration count and values
within 1e-6 (the two packages sum in different orders).  Within the
port, a replayed trace is bit-identical.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from _torch_parity import coo_of, fresh_coords, port_csr

from repro.core import delta as rdelta
from repro.core import generators as rg
from repro.graph import drivers as rdrv
import repro.serve_graph as rsg
from repro_torch.core import delta as tdelta
from repro_torch.graph import drivers as tdrv
import repro_torch.serve_graph as tsg

N = 64
PR_ATOL = 1e-6
#: engine stats the two packages share (the port adds lanes counters;
#: compile_s is wall-clock time)
CACHE_KEYS = ("plans", "hits", "misses", "evictions", "compiles",
              "overlays", "swaps", "delta_recompiles", "hit_rate")


@dataclasses.dataclass
class Side:
    """One package: its serving module, drivers, delta module and the
    keyword that puts its plans on the CPU."""
    name: str
    sg: types.ModuleType
    drv: types.ModuleType
    D: types.ModuleType
    dkw: dict

    def engine(self, graphs, **over):
        cfg = {**dict(n_lanes=8, compile_queue_cap=4, compiles_per_step=1),
               **over, **self.dkw}
        eng = self.sg.GraphEngine(self.sg.GraphEngineConfig(**cfg))
        for gid, adj in graphs.items():
            eng.register_graph(gid, adj if self.name == "ref"
                               else port_csr(adj))
        return eng

    def driver(self, analytic, adj, *args, **kw):
        return self.drv.DRIVERS[analytic](adj, *args, **kw, **self.dkw)


REF = Side("ref", rsg, rdrv, rdelta, {})
PORT = Side("port", tsg, tdrv, tdelta, {"device": "cpu"})


def _graphs(n=N):
    return {"fd": rg.fd_matrix(n, seed=3), "rmat": rg.rmat_matrix(n, seed=3)}


def _stats(eng):
    s = eng.stats()
    cache = {k: s["plan_cache"][k] for k in CACHE_KEYS}
    keep = {k: v for k, v in s.items()
            if k not in ("plan_cache", "lanes", "padded_lanes")}
    return keep, cache


def _assert_same_results(a, b):
    """Results of the two packages (or two runs) agree: steps, counts,
    and values (PageRank within PR_ATOL, the rest equal)."""
    assert sorted(a) == sorted(b)
    for rid in a:
        ra, rb = a[rid], b[rid]
        assert (rb.n_iters, rb.converged, rb.arrived_step, rb.admitted_step,
                rb.finished_step, rb.restarts, rb.analytic) == \
            (ra.n_iters, ra.converged, ra.arrived_step, ra.admitted_step,
             ra.finished_step, ra.restarts, ra.analytic), rid
        assert rb.values.shape == ra.values.shape
        if ra.analytic == "pagerank":
            np.testing.assert_allclose(rb.values, ra.values, rtol=0,
                                       atol=PR_ATOL)
        else:
            assert np.array_equal(rb.values, ra.values), rid


def _both(scenario, *args, **kw):
    """Run `scenario(side, ...)` on both packages; the schedules,
    statistics and results must agree.  Returns the port's output."""
    a = scenario(REF, *args, **kw)
    b = scenario(PORT, *args, **kw)
    assert b["log"] == a["log"]
    assert b["stats"] == a["stats"]
    assert b.get("actions") == a.get("actions")
    _assert_same_results(a["results"], b["results"])
    return b


def _summary(eng, out, **extra):
    return {"log": list(eng.scheduler.log), "stats": _stats(eng),
            "results": out, "eng": eng, **extra}


def _prime(eng, *pairs):
    for gid, analytic in pairs:
        eng._compile_key(eng._derive(gid, analytic).key)


# ---------------------------------------------------------------------------
# engine correctness vs the blocking drivers
# ---------------------------------------------------------------------------

def _driver_scenario(side, n):
    g = _graphs(n)
    eng = side.engine(g)
    eng.submit(side.sg.AnalyticRequest(0, "fd", "bfs", sources=(0, 5)))
    eng.submit(side.sg.AnalyticRequest(1, "rmat", "pagerank",
                                       params={"tol": 1e-6}))
    eng.submit(side.sg.AnalyticRequest(2, "fd", "sssp", sources=(3,)))
    eng.submit(side.sg.AnalyticRequest(3, "rmat", "connected_components"))
    out = eng.run()
    fd, rmat = eng.graphs["fd"], eng.graphs["rmat"]
    assert np.array_equal(out[0].values,
                          side.driver("bfs", fd, [0, 5]).values)
    ref = side.driver("pagerank", rmat, tol=1e-6)
    assert out[1].n_iters == ref.n_iters
    assert np.array_equal(out[1].values[0], ref.values) or \
        side.name == "ref"
    assert np.array_equal(out[2].values[0],
                          side.driver("sssp", fd, 3).values)
    assert np.array_equal(out[3].values[0], side.driver(
        "connected_components", rmat).values)
    return _summary(eng, out)


@pytest.mark.parametrize("n", [N, 1 << 10])
def test_engine_matches_blocking_drivers(n):
    """On the port the engine's PageRank equals the blocking driver's bit
    for bit: each row of a CPU plan's `execute_many` is what `execute`
    gives that row."""
    _both(_driver_scenario, n)


def _empty_and_cap(side):
    eng = side.engine(_graphs())
    eng.submit(side.sg.AnalyticRequest(0, "fd", "bfs", sources=()))
    eng.submit(side.sg.AnalyticRequest(1, "rmat", "pagerank",
                                       params={"tol": 0.0}, max_iters=3))
    out = eng.run()
    assert out[0].values.shape == (0, N) and out[0].converged
    assert out[0].n_iters == 0
    assert out[1].n_iters == 3 and not out[1].converged
    return _summary(eng, out)


def test_engine_empty_sources_and_iteration_cap():
    _both(_empty_and_cap)


def test_engine_rejects_malformed_requests_like_the_reference():
    bad = [(KeyError, dict(req_id=0, graph_id="nope", analytic="bfs",
                           sources=(0,))),
           (ValueError, dict(req_id=1, graph_id="fd",
                             analytic="betweenness")),
           (ValueError, dict(req_id=2, graph_id="fd", analytic="bfs",
                             sources=(N + 5,))),
           (ValueError, dict(req_id=3, graph_id="fd", analytic="bfs",
                             sources=tuple(range(9)))),
           (ValueError, dict(req_id=4, graph_id="fd",
                             analytic="connected_components",
                             sources=(1,)))]
    msgs = {}
    for side in (REF, PORT):
        eng = side.engine(_graphs())
        for exc, kw in bad:
            with pytest.raises(exc) as e:
                eng.submit(side.sg.AnalyticRequest(**kw))
            msgs.setdefault(kw["req_id"], []).append(str(e.value))
        with pytest.raises(KeyError, match="not registered"):
            eng.submit(side.sg.GraphMutation(0, "nope",
                                             inserts=((0, 1, 1.0),)))
        with pytest.raises(ValueError, match="square"):
            eng.register_graph("wide", types.SimpleNamespace(n_rows=2,
                                                             n_cols=3))
        assert eng.submitted == 0 and eng.idle
    assert all(a == b for a, b in msgs.values())


def test_engine_defaults_to_the_card():
    """device=None means the card: without one the engine refuses."""
    if torch.cuda.is_available():
        assert tsg.GraphEngine().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsg.GraphEngine()


def test_engine_plans_share_the_drivers_cache_entries():
    """The engine keys through the drivers' `plan_options`: a request
    after a blocking run on the same cache is a warm hit."""
    from repro_torch.plan import PlanCache

    cache = PlanCache()
    g = port_csr(rg.rmat_matrix(N, seed=3))
    tdrv.sssp(g, 0, plan_cache=cache, device="cpu")
    eng = tsg.GraphEngine(tsg.GraphEngineConfig(device="cpu"),
                          plan_cache=cache)
    eng.register_graph("g", g)
    eng.submit(tsg.AnalyticRequest(0, "g", "sssp", sources=(0,)))
    eng.run()
    s = eng.stats()
    assert s["warm_hits"] == 1 and s["cold_misses"] == 0
    assert s["plan_cache"]["compiles"] == 1


# ---------------------------------------------------------------------------
# admission: warm pool vs bounded compile queue
# ---------------------------------------------------------------------------

def _warm_hits(side):
    eng = side.engine(_graphs())
    _prime(eng, ("fd", "bfs"))
    eng.submit(side.sg.AnalyticRequest(0, "fd", "bfs", sources=(0,)))
    eng.submit(side.sg.AnalyticRequest(1, "rmat", "bfs", sources=(0,)))
    eng.step()
    s = eng.stats()
    assert s["warm_hits"] == 1 and s["cold_misses"] == 1
    assert (1, "admit", 0) in eng.scheduler.log
    out = eng.run()
    assert len(out) == 2
    return _summary(eng, out)


def _backpressure(side):
    eng = side.engine(_graphs(), compile_queue_cap=1)
    _prime(eng, ("fd", "bfs"))
    eng.submit(side.sg.AnalyticRequest(0, "rmat", "bfs", sources=(0,)))
    # tol 1e-6: at the default 1e-8 the float32 residual sits in rounding
    # noise and the packages' summation orders stop it apart
    eng.submit(side.sg.AnalyticRequest(1, "rmat", "pagerank",
                                       params={"tol": 1e-6}))
    eng.submit(side.sg.AnalyticRequest(2, "fd", "bfs", sources=(1,)))
    eng.step()
    assert eng.stats()["backpressure"] >= 1
    assert (1, "admit", 2) in eng.scheduler.log
    assert all(e[2] != 1 for e in eng.scheduler.log)
    out = eng.run()
    assert sorted(out) == [0, 1, 2] and all(r.converged
                                            for r in out.values())
    return _summary(eng, out)


def _coalesced_compiles(side):
    eng = side.engine(_graphs())
    for i in range(5):
        eng.submit(side.sg.AnalyticRequest(i, "rmat", "bfs", sources=(i,)))
    out = eng.run()
    assert eng.plan_cache.stats()["compiles"] == 1 and len(out) == 5
    return _summary(eng, out)


def _coalesced_spmm(side):
    eng = side.engine(_graphs(), n_lanes=16)
    _prime(eng, ("fd", "bfs"))
    for i in range(4):
        eng.submit(side.sg.AnalyticRequest(i, "fd", "bfs",
                                           sources=(i, i + 8)))
    out = eng.run()
    assert eng.spmm_calls < sum(r.n_iters for r in out.values())
    assert eng.spmm_calls == max(r.n_iters for r in out.values())
    for i in range(4):
        assert np.array_equal(out[i].values, side.driver(
            "bfs", eng.graphs["fd"], [i, i + 8]).values)
    return _summary(eng, out)


def _drain(side, budget):
    eng = side.engine(_graphs(), compiles_per_step=budget)
    eng.submit(side.sg.AnalyticRequest(0, "fd", "bfs", sources=(0,)))
    eng.submit(side.sg.AnalyticRequest(1, "rmat", "bfs", sources=(0,)))
    eng.submit(side.sg.AnalyticRequest(2, "fd", "sssp", sources=(1,)))
    eng.step()
    queued = len(eng.admission.compile_q)
    admitted = {e[2] for e in eng.scheduler.log if e[1] == "admit"}
    out = eng.run()
    return _summary(eng, out, queued=queued, admitted=admitted)


@pytest.mark.parametrize("scenario", [_warm_hits, _backpressure,
                                      _coalesced_compiles, _coalesced_spmm],
                         ids=lambda f: f.__name__.strip("_"))
def test_admission_and_coalescing_match_reference(scenario):
    _both(scenario)


def test_drain_compile_queue_admits_in_one_step():
    """compiles_per_step=None compiles every queued plan the step it is
    queued (the reference pairs it with model-scored compiles; the
    drain itself does not depend on the scoring)."""
    paced = _both(_drain, 1)
    drain = _both(_drain, None)
    assert drain["queued"] == 0 and paced["queued"] > 0
    assert drain["admitted"] == {0, 1, 2}
    assert {r: v.values.tobytes() for r, v in drain["results"].items()} == \
        {r: v.values.tobytes() for r, v in paced["results"].items()}


def _fleet(side, **over):
    eng = side.engine(_graphs(), **over)
    for i in range(4):
        eng.submit(side.sg.AnalyticRequest(i, "fd" if i % 2 else "rmat",
                                           "bfs", sources=(i,)))
    eng.submit(side.sg.AnalyticRequest(4, "rmat", "pagerank",
                                       params={"tol": 1e-6}))
    out = eng.run()
    st = eng.plan_cache.stats()
    split = {k: st[k] for k in ("compiles", "predictor_compiles",
                                "oracle_compiles")}
    plans = sorted((v.chosen, v.format_name, v.compile_stats["scoring"])
                   for v in eng.plan_cache._plans.values())
    return _summary(eng, out, split=split, plans=plans)


def test_model_scored_serving_matches_oracle_bitwise():
    """Counterpart of tests/test_serve_graph.py's case of the same name:
    predictor='model' (queue drained every step) serves bit-identical
    results to the replay-scored oracle, scoring picks the reference's
    plans, and the cache splits its compiles by scoring as the
    reference's does."""
    outs = {}
    for mode, budget in (("model", None), ("replay", 1)):
        kw = dict(reorder="auto", predictor=mode, compiles_per_step=budget)
        a, b = _fleet(REF, **kw), _fleet(PORT, **kw)
        assert b["log"] == a["log"] and b["stats"] == a["stats"]
        assert (b["split"], b["plans"]) == (a["split"], a["plans"])
        _assert_same_results(a["results"], b["results"])
        outs[mode] = b
    m, o = outs["model"], outs["replay"]
    assert {r: v.values.tobytes() for r, v in m["results"].items()} == \
        {r: v.values.tobytes() for r, v in o["results"].items()}
    assert m["split"]["predictor_compiles"] == m["split"]["compiles"] > 0
    assert m["split"]["oracle_compiles"] == 0
    assert o["split"]["oracle_compiles"] == o["split"]["compiles"] > 0
    assert o["split"]["predictor_compiles"] == 0


# ---------------------------------------------------------------------------
# preemption and determinism
# ---------------------------------------------------------------------------

def _preemption(side):
    eng = side.engine(_graphs(), n_lanes=3, compile_queue_cap=4,
                      max_iters_default=12)
    _prime(eng, ("fd", "pagerank"))
    eng.submit(side.sg.AnalyticRequest(10, "rmat", "bfs", sources=(0,)))
    eng.submit(side.sg.AnalyticRequest(11, "rmat", "pagerank"))
    eng.submit(side.sg.AnalyticRequest(0, "rmat", "sssp", sources=(0,)))
    for i in (1, 2, 3):
        eng.submit(side.sg.AnalyticRequest(i, "fd", "pagerank",
                                           params={"tol": 0.0}))
    return _summary(eng, eng.run())


def test_preemption_youngest_first_matches_reference():
    out = _both(_preemption)
    preempts = [e for e in out["log"] if e[1] == "preempt"]
    assert preempts and preempts[0][2] == 3
    res = out["results"]
    assert res[0].converged and res[0].restarts == 0
    assert res[3].restarts >= 1 and res[3].n_iters == 12
    assert len(res) == 6
    assert {"admit", "preempt", "finish"} <= {e[1] for e in out["log"]}


def test_identical_traces_replay_bit_for_bit_on_the_port():
    a, b = _preemption(PORT), _preemption(PORT)
    assert a["log"] == b["log"] and a["stats"] == b["stats"]
    assert {r: (v.values.tobytes(), v.n_iters, v.restarts)
            for r, v in a["results"].items()} == \
        {r: (v.values.tobytes(), v.n_iters, v.restarts)
         for r, v in b["results"].items()}


def test_lanes_and_padded_lanes_are_counted():
    """Three lanes on one plan pad to four under `lane_bucket`; without
    it nothing pads."""
    for bucket, pad in ((True, 1), (False, 0)):
        eng = PORT.engine(_graphs(), lane_bucket=bucket)
        eng.submit(tsg.AnalyticRequest(0, "fd", "bfs", sources=(0, 1, 2)))
        out = eng.run()
        s = eng.stats()
        assert s["lanes"] == 3 * out[0].n_iters
        assert s["padded_lanes"] == pad * out[0].n_iters


# ---------------------------------------------------------------------------
# the mutation lifecycle
# ---------------------------------------------------------------------------

def _mut_engine(side, n=128, **over):
    return side.engine({"g": rg.rmat_matrix(n, seed=3)}, **over)


def _inserts(adj, k, seed=0):
    return tuple((r, c, 1.0) for r, c in
                 fresh_coords(adj, k, np.random.default_rng(seed)))


def _actions(eng):
    return {m: r.actions for m, r in eng.mutation_results.items()}


def _overlay_warm(side, n=128):
    eng = _mut_engine(side, n)
    eng.submit(side.sg.AnalyticRequest(0, "g", "sssp", sources=(0,)))
    eng.run()
    before = eng.plan_cache.stats()["compiles"]
    eng.submit(side.sg.GraphMutation(100, "g",
                                     inserts=_inserts(eng.graphs["g"], 2)))
    eng.submit(side.sg.AnalyticRequest(1, "g", "sssp", sources=(0,)))
    out = eng.run()
    s = eng.stats()
    assert _actions(eng) == {100: {"sssp": "overlay"}}
    assert s["plan_cache"]["overlays"] == 1
    assert s["plan_cache"]["compiles"] == before
    assert s["cold_misses"] == 1 and s["mutations_applied"] == 1
    assert np.array_equal(out[1].values[0],
                          side.driver("sssp", eng.graphs["g"], 0).values)
    return _summary(eng, out, actions=_actions(eng))


def _past_budget(side):
    eng = _mut_engine(side, staleness_budget=0.0005)
    eng.submit(side.sg.AnalyticRequest(0, "g", "sssp", sources=(0,)))
    eng.run()
    eng.submit(side.sg.GraphMutation(100, "g",
                                     inserts=_inserts(eng.graphs["g"], 4)))
    eng.submit(side.sg.AnalyticRequest(1, "g", "sssp", sources=(0,)))
    out = eng.run()
    assert _actions(eng) == {100: {"sssp": "replan"}}
    s = eng.stats()["plan_cache"]
    assert (s["delta_recompiles"], s["swaps"], s["overlays"]) == (1, 1, 0)
    assert np.array_equal(out[1].values[0],
                          side.driver("sssp", eng.graphs["g"], 0).values)
    return _summary(eng, out, actions=_actions(eng))


def _ineligible_delete(side):
    eng = _mut_engine(side)
    eng.submit(side.sg.AnalyticRequest(0, "g", "sssp", sources=(0,)))
    eng.run()
    rows, cols, _ = coo_of(eng.graphs["g"])
    eng.submit(side.sg.GraphMutation(
        100, "g", deletes=((int(rows[0]), int(cols[0])),)))
    eng.submit(side.sg.AnalyticRequest(1, "g", "sssp", sources=(0,)))
    out = eng.run()
    assert _actions(eng) == {100: {"sssp": "replan"}}
    assert np.array_equal(out[1].values[0],
                          side.driver("sssp", eng.graphs["g"], 0).values)
    return _summary(eng, out, actions=_actions(eng))


def _chained(side):
    eng = _mut_engine(side, staleness_budget=0.05)
    eng.submit(side.sg.AnalyticRequest(0, "g", "sssp", sources=(0,)))
    eng.run()
    for i in range(2):
        eng.submit(side.sg.GraphMutation(
            100 + i, "g", inserts=_inserts(eng.graphs["g"], 2, seed=i)))
        eng.submit(side.sg.AnalyticRequest(1 + i, "g", "sssp",
                                           sources=(0,)))
        eng.run()
        assert eng.mutation_results[100 + i].actions == {"sssp": "overlay"}
    assert eng.stats()["plan_cache"]["overlays"] == 2
    big = _inserts(eng.graphs["g"], int(0.06 * eng.graphs["g"].nnz), seed=9)
    eng.submit(side.sg.GraphMutation(102, "g", inserts=big))
    eng.submit(side.sg.AnalyticRequest(3, "g", "sssp", sources=(0,)))
    out = eng.run()
    assert eng.mutation_results[102].actions == {"sssp": "replan"}
    assert np.array_equal(out[3].values[0],
                          side.driver("sssp", eng.graphs["g"], 0).values)
    return _summary(eng, out, actions=_actions(eng))


def _inflight(side, n=128):
    eng = _mut_engine(side, n)
    src = int(np.argmax(eng.graphs["g"].row_lengths()))
    eng.submit(side.sg.AnalyticRequest(0, "g", "sssp", sources=(src,)))
    eng.submit(side.sg.AnalyticRequest(1, "g", "connected_components"))
    eng.submit(side.sg.AnalyticRequest(2, "g", "pagerank",
                                       params={"tol": 1e-6}))
    for _ in range(3):
        eng.step()
    assert eng.scheduler.running
    eng.submit(side.sg.GraphMutation(100, "g",
                                     inserts=_inserts(eng.graphs["g"], 2)))
    out = eng.run()
    assert _actions(eng) == {100: {"sssp": "overlay",
                                   "connected_components": "overlay",
                                   "pagerank": "overlay"}}
    g = eng.graphs["g"]
    assert np.array_equal(out[0].values[0],
                          side.driver("sssp", g, src).values)
    assert np.array_equal(out[1].values[0],
                          side.driver("connected_components", g).values)
    np.testing.assert_allclose(out[2].values[0], side.driver(
        "pagerank", g, tol=1e-6).values, rtol=1e-3, atol=1e-4)
    return _summary(eng, out, actions=_actions(eng))


def _before_any_request(side):
    eng = _mut_engine(side)
    eng.submit(side.sg.GraphMutation(100, "g",
                                     inserts=_inserts(eng.graphs["g"], 2)))
    eng.submit(side.sg.AnalyticRequest(0, "g", "sssp", sources=(0,)))
    out = eng.run()
    assert _actions(eng) == {100: {}}
    assert np.array_equal(out[0].values[0],
                          side.driver("sssp", eng.graphs["g"], 0).values)
    return _summary(eng, out, actions=_actions(eng))


def _trace(side, n=128):
    eng = _mut_engine(side, n, staleness_budget=0.002)
    g0 = eng.graphs["g"]
    eng.submit(side.sg.AnalyticRequest(0, "g", "sssp", sources=(0, 1)))
    eng.submit(side.sg.AnalyticRequest(1, "g", "pagerank",
                                       params={"tol": 1e-5}, max_iters=64))
    for _ in range(3):
        eng.step()
    first = _inserts(g0, 1)
    eng.submit(side.sg.GraphMutation(100, "g", inserts=first))
    eng.submit(side.sg.AnalyticRequest(2, "g", "sssp", sources=(2,)))
    eng.submit(side.sg.GraphMutation(101, "g", inserts=tuple(
        (r, c, 1.0) for r, c in fresh_coords(
            g0, 6, np.random.default_rng(5),
            avoid=[i[:2] for i in first]))))
    out = eng.run()
    return _summary(eng, out, actions=_actions(eng))


LIFECYCLE = [(f, 128) for f in (_overlay_warm, _past_budget,
                                 _ineligible_delete, _chained, _inflight,
                                 _before_any_request, _trace)] + \
    [(f, 1 << 10) for f in (_overlay_warm, _inflight, _trace)]


@pytest.mark.parametrize("scenario,n", LIFECYCLE,
                         ids=[f"{f.__name__.strip('_')}-{n}"
                              for f, n in LIFECYCLE])
def test_mutation_lifecycle_matches_reference(scenario, n):
    """Overlay, past-budget re-plan with one swap, an ineligible delete,
    chained mutations, in-flight rebinding with warm starts, a mutation
    before any request and a replayed trace (on a 128-vertex graph, and
    three of them at 2^10): the reference's actions, counters, schedule
    and answers."""
    kw = {} if n == 128 else {"n": n}
    _both(scenario, **kw)


def test_mutation_trace_replays_bit_for_bit_on_the_port():
    a, b = _trace(PORT), _trace(PORT)
    assert a["log"] == b["log"] and a["actions"] == b["actions"]
    assert a["stats"] == b["stats"]
    assert {r: (v.values.tobytes(), v.n_iters)
            for r, v in a["results"].items()} == \
        {r: (v.values.tobytes(), v.n_iters)
         for r, v in b["results"].items()}
    assert set(a["actions"][100].values()) == {"replan", "overlay"}


def test_mutation_seconds_are_logged():
    out = _inflight(PORT)
    secs = out["eng"].mutation_seconds[100]
    assert set(secs) == {"delta_s", "operand_s", "diff_s", "merge_s",
                         "overlay_s", "key_s", "host_s"}
    assert all(v >= 0.0 for v in secs.values())
    assert secs["host_s"] >= secs["operand_s"] + secs["diff_s"]
