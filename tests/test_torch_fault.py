"""The port's fault-tolerance module (`repro_torch.distributed.fault`, a
copy of the reference's pure-Python one): the reference's tests
(`tests/test_fault.py`) mirrored on the port, and the same decisions as
the reference's on the same event sequences."""
import dataclasses

import numpy as np
import pytest

from repro.distributed import fault as rfault
from repro_torch.distributed.fault import (HeartbeatMonitor, RescalePlan,
                                           StragglerDetector, Supervisor,
                                           WorkerState, plan_elastic_rescale)


def test_heartbeat_detects_dead_worker():
    hb = HeartbeatMonitor(n_workers=3, timeout_s=10.0)
    hb.beat(0, 1, now=100.0)
    hb.beat(1, 1, now=100.0)
    hb.beat(2, 1, now=100.0)
    hb.beat(0, 2, now=120.0)
    hb.beat(1, 2, now=120.0)
    assert hb.dead_workers(now=120.5) == [2]
    assert not hb.healthy(now=120.5)
    assert hb.workers[0] == WorkerState(last_seen=120.0, last_step=2)


def test_heartbeat_never_seen_is_not_dead():
    hb = HeartbeatMonitor(n_workers=2, timeout_s=1.0)
    assert hb.healthy(now=1000.0)     # bootstrap grace


def test_straggler_detection():
    sd = StragglerDetector(k=2.0, window=8)
    for step in range(8):
        for w in range(4):
            sd.record(w, 1.0 if w != 3 else 5.0)
    assert sd.stragglers() == [3]
    assert "rebalance" in sd.mitigation(3) or "row-block" in sd.mitigation(3)


def test_rescale_plan_shrinks_data_axis():
    plan = plan_elastic_rescale({"pod": 2, "data": 16, "model": 16},
                                n_devices_now=384)   # lost 128 chips
    assert plan.new_mesh[0] == 2 and plan.new_mesh[2] == 16
    assert plan.new_mesh[1] == 8                     # next pow2 below 12
    assert plan.data_resize == 0.5


def test_rescale_plan_single_pod():
    plan = plan_elastic_rescale({"data": 16, "model": 16},
                                n_devices_now=128)
    assert plan.new_mesh == (8, 16)


def test_supervisor_restarts_and_succeeds():
    calls = {"makes": 0, "fails": 0}

    def make_state():
        calls["makes"] += 1
        return {"step": 0}

    def step_fn(state, step):
        if step == 3 and calls["fails"] < 2:
            calls["fails"] += 1
            raise RuntimeError("boom")
        return {"step": step + 1}

    sup = Supervisor(max_restarts=3)
    state = sup.run(make_state, step_fn, n_steps=6)
    assert state["step"] == 6
    assert sup.restarts == 2
    assert sup.failures == ["step 3: RuntimeError: boom"] * 2


def test_supervisor_gives_up_after_max_restarts():
    def make_state():
        return {"step": 0}

    def step_fn(state, step):
        raise RuntimeError("always")

    sup = Supervisor(max_restarts=2)
    with pytest.raises(RuntimeError, match="exceeded"):
        sup.run(make_state, step_fn, n_steps=3)


@pytest.mark.parametrize("mesh,n", [
    ({"pod": 2, "data": 16, "model": 16}, 384),
    ({"data": 16, "model": 16}, 128), ({"data": 8, "model": 4}, 20),
    ({"pod": 4, "data": 4, "model": 2}, 7), ({"data": 1, "model": 8}, 8)])
def test_rescale_plans_equal_the_references(mesh, n):
    got = plan_elastic_rescale(dict(mesh), n)
    want = rfault.plan_elastic_rescale(dict(mesh), n)
    assert isinstance(got, RescalePlan)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_monitors_decide_as_the_references_do():
    """A seeded trace of beats and step times: the same dead workers,
    medians and stragglers at every point."""
    rng = np.random.default_rng(4)
    ours = (HeartbeatMonitor(6, timeout_s=5.0), StragglerDetector(k=1.5,
                                                                  window=5))
    theirs = (rfault.HeartbeatMonitor(6, timeout_s=5.0),
              rfault.StragglerDetector(k=1.5, window=5))
    now = 0.0
    for step in range(60):
        now += float(rng.uniform(0.1, 2.0))
        for w in range(6):
            if rng.uniform() < 0.8:
                for hb, _ in (ours, theirs):
                    hb.beat(w, step, now=now)
            t = float(rng.gamma(2.0, 1.0 + (w == 4)))
            for _, sd in (ours, theirs):
                sd.record(w, t)
        probe = now + float(rng.uniform(0, 6))
        assert ours[0].dead_workers(probe) == theirs[0].dead_workers(probe)
        assert ours[1].medians() == theirs[1].medians()
        assert ours[1].stragglers() == theirs[1].stragglers()
