"""Fault tolerance: heartbeats, straggler detection, elastic rescale plans
(the port's copy of `repro.distributed.fault`, which is pure Python).

On a real cluster these hook the launcher's control plane (GRPC/etcd); the
logic is identical on one host, so it is implemented and unit-tested here
and wired into launch/train.py's supervisor loop:

  * HeartbeatMonitor  -- declares workers dead after `timeout_s` silence;
  * StragglerDetector -- flags workers whose step time exceeds
    k x rolling-median; emits a mitigation (re-balance rows for SpMV jobs,
    shrink microbatch or evict for LM jobs);
  * plan_elastic_rescale -- maps a committed checkpoint onto a new device
    count (data-axis resize only: model-parallel degree is part of the
    lowered program and never resized in place);
  * Supervisor -- restart-on-failure wrapper with bounded retries and
    deterministic data replay (resume step comes from the checkpoint).
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class WorkerState:
    last_seen: float
    last_step: int


class HeartbeatMonitor:
    def __init__(self, n_workers: int, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.workers: Dict[int, WorkerState] = {
            i: WorkerState(last_seen=-1.0, last_step=-1)
            for i in range(n_workers)}

    def beat(self, worker: int, step: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self.workers[worker] = WorkerState(last_seen=now, last_step=step)

    def dead_workers(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [w for w, st in self.workers.items()
                if st.last_seen >= 0 and now - st.last_seen > self.timeout_s]

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_workers(now)


class StragglerDetector:
    """Rolling-median step-time watchdog (paper analogy: the permuted R-MAT
    rows equalize *work*; stragglers come from the *machine*, so detection
    is temporal, not structural)."""

    def __init__(self, k: float = 2.0, window: int = 32):
        self.k = k
        self.times: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, worker: int, step_time_s: float):
        self.times[worker].append(step_time_s)

    def medians(self) -> Dict[int, float]:
        out = {}
        for w, ts in self.times.items():
            s = sorted(ts)
            out[w] = s[len(s) // 2] if s else 0.0
        return out

    def stragglers(self) -> List[int]:
        med = self.medians()
        if not med:
            return []
        global_med = sorted(med.values())[len(med) // 2]
        if global_med <= 0:
            return []
        return [w for w, m in med.items() if m > self.k * global_med]

    def mitigation(self, worker: int) -> str:
        return (f"worker {worker}: reassign its row-block via "
                f"partition.rowblock_balanced excluding it, or evict and "
                f"elastic-rescale the data axis")


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_mesh: tuple
    new_mesh: tuple
    data_resize: float          # new_data / old_data
    batch_per_host_change: float
    notes: str


def plan_elastic_rescale(old_mesh: Dict[str, int], n_devices_now: int
                         ) -> RescalePlan:
    """Resize the data axis to fit the surviving device count.

    model (and pod) degrees are fixed by the compiled program; the data axis
    shrinks to the largest size that divides the survivors.  Checkpoints
    restore unchanged (params are sharded over model; the data axis only
    replicates/FSDP-shards them, and the CheckpointManager reshards byte
    ranges on read).
    """
    model = old_mesh.get("model", 1)
    pod = old_mesh.get("pod", 1)
    per_pod = n_devices_now // pod
    new_data = max(per_pod // model, 1)
    # data axes prefer powers of two (collective efficiency)
    while new_data & (new_data - 1):
        new_data -= 1
    old = tuple(old_mesh.values())
    new = (pod, new_data, model) if "pod" in old_mesh else (new_data, model)
    old_data = old_mesh.get("data", 1)
    return RescalePlan(
        old_mesh=old, new_mesh=new, data_resize=new_data / old_data,
        batch_per_host_change=old_data / new_data,
        notes=(f"global batch kept constant: per-device batch scales by "
               f"{old_data / new_data:.2f}; grad-accumulation steps scale "
               f"inversely; dataset replay deterministic from step counter"),
    )


class Supervisor:
    """Run a step loop with bounded restart-on-failure."""

    def __init__(self, max_restarts: int = 3):
        self.max_restarts = max_restarts
        self.restarts = 0
        self.failures: List[str] = []

    def run(self, make_state: Callable[[], dict],
            step_fn: Callable[[dict, int], dict],
            n_steps: int, start_step: int = 0,
            fail_injector: Optional[Callable[[int], None]] = None) -> dict:
        """`make_state()` must restore from the latest checkpoint."""
        while True:
            state = make_state()
            step = int(state.get("step", start_step))
            try:
                while step < n_steps:
                    if fail_injector is not None:
                        fail_injector(step)
                    state = step_fn(state, step)
                    step = int(state.get("step", step + 1))
                return state
            except Exception as e:  # noqa: BLE001 -- supervisor boundary
                self.restarts += 1
                self.failures.append(f"step {step}: {type(e).__name__}: {e}")
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts; "
                        f"failures={self.failures}") from e
