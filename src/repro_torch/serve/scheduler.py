"""Continuous-batching scheduler (vLLM-style) with block-pool admission:
the reference's `repro.serve.scheduler`, line for line, over the port's
`BlockAllocator` (which makes the reference's decisions exactly).

Policy:
  * requests queue FIFO; a request is admitted when (a) a batch slot is
    free and (b) the allocator can cover its prompt + one decode block;
  * every decode step extends each running sequence by one token; if the
    pool is exhausted the *youngest* running sequence is preempted back to
    the queue (its blocks freed, prompt re-queued) -- strict FIFO progress
    for the oldest work, no deadlock;
  * finished sequences (EOS or max_new_tokens) release immediately.

The scheduler is deliberately host-side and deterministic: identical
request traces produce identical schedules, which the tests rely on.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

from .kv_blocks import BlockAllocator, PoolConfig


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: list                 # token ids
    max_new_tokens: int
    arrived_step: int = 0
    generated: list = dataclasses.field(default_factory=list)

    @property
    def context_len(self) -> int:
        return len(self.prompt) + len(self.generated)


@dataclasses.dataclass
class Slot:
    slot_id: int
    req: Optional[Request] = None

    @property
    def free(self) -> bool:
        return self.req is None


class Scheduler:
    def __init__(self, pool_cfg: PoolConfig, max_batch: int,
                 eos_id: int = -1):
        self.alloc = BlockAllocator(pool_cfg)
        self.slots = [Slot(i) for i in range(max_batch)]
        self.queue: Deque[Request] = deque()
        self.eos_id = eos_id
        self.finished: List[Request] = []
        self.step_count = 0
        self.preemptions = 0

    # -- intake ---------------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.arrived_step = self.step_count
        self.queue.append(req)

    # -- scheduling -----------------------------------------------------------

    def admit_waiting(self) -> List[Slot]:
        """Fill free slots from the queue while blocks allow.  Returns the
        slots that need a prefill this step."""
        newly = []
        for slot in self.slots:
            if not slot.free or not self.queue:
                continue
            req = self.queue[0]
            if not self.alloc.can_admit(req.context_len + 1):
                break     # FIFO: do not skip ahead of the head request
            self.queue.popleft()
            self.alloc.admit((slot.slot_id, req.req_id), req.context_len)
            slot.req = req
            newly.append(slot)
        return newly

    def _seq_key(self, slot: Slot):
        # (slot, request) tuple: additive schemes collide (slot 4 + req 0
        # == slot 0 + req 4) and corrupt the allocator's tables
        return (slot.slot_id, slot.req.req_id)

    def running(self) -> List[Slot]:
        return [s for s in self.slots if not s.free]

    def pre_decode(self) -> List[Slot]:
        """Extend every running sequence by one token; preempt youngest on
        pool exhaustion.  Returns slots participating in this decode step."""
        run = self.running()
        # youngest-first preemption order
        by_age = sorted(run, key=lambda s: s.req.arrived_step)
        for slot in run:
            ok = self.alloc.extend(self._seq_key(slot), 1)
            if not ok:
                victim = by_age[-1]
                self._preempt(victim)
                by_age.pop()
                if victim is slot:
                    continue
                if not self.alloc.extend(self._seq_key(slot), 1):
                    self._preempt(slot)
        return self.running()

    def _preempt(self, slot: Slot) -> None:
        req = slot.req
        self.alloc.release(self._seq_key(slot))
        # restart from scratch (prompt + already-generated become the prompt)
        req.prompt = list(req.prompt) + list(req.generated)
        req.generated = []
        self.queue.appendleft(req)
        slot.req = None
        self.preemptions += 1

    def post_decode(self, slot: Slot, token: int) -> None:
        req = slot.req
        req.generated.append(int(token))
        done = (token == self.eos_id
                or len(req.generated) >= req.max_new_tokens)
        if done:
            self.alloc.release(self._seq_key(slot))
            self.finished.append(req)
            slot.req = None

    def tick(self) -> None:
        self.step_count += 1

    @property
    def idle(self) -> bool:
        return not self.queue and all(s.free for s in self.slots)

    def stats(self) -> Dict[str, float]:
        return {
            "queued": len(self.queue),
            "running": len(self.running()),
            "finished": len(self.finished),
            "pool_utilization": self.alloc.utilization(),
            "preemptions": self.preemptions,
            "steps": self.step_count,
        }
