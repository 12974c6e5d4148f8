"""Parity of the port's LM serving path (`repro_torch.serve.scheduler`,
`serve.engine`, `launch.serve`) with the reference's on the CPU.

The scheduler is host logic and must log exactly what the reference's
logs on the same trace.  The engines run the same parameters (the
reference's, carried across by `convert.params_from_reference`) on a
float32 reduced config, where greedy tokens must be equal, through both
of the port's attention routes (the kernels' plain versions here, and
the plain attention).
"""
import dataclasses

import numpy as np
import pytest
import torch
from _opt_deps import given, settings, st
from _lm_parity import configs, shared_params

from repro.launch import serve as rlaunch
from repro.serve import EngineConfig as REngineConfig, Request as RRequest
from repro.serve import PoolConfig as RPoolConfig, Scheduler as RScheduler
from repro.serve.engine import Engine as REngine
from repro_torch.configs import CONFIGS
from repro_torch.launch import serve as tlaunch
from repro_torch.models import registry as treg
from repro_torch.serve import (Engine, EngineConfig, PoolConfig, Request,
                               Scheduler, make_engine)

KERNEL_ROUTES = [True, False]


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def scheduler_log(Sched, Req, Pool, trace, n_blocks, block, max_blocks,
                  max_batch, eos_id):
    """Drive a scheduler over `trace` ((prompt_len, max_new) pairs) with
    tokens that depend on the step and slot only; log every decision,
    and the reference's AttributeError where it raises one."""
    s = Sched(Pool(n_blocks=n_blocks, block_size=block,
                   max_blocks_per_seq=max_blocks), max_batch, eos_id=eos_id)
    for rid, (plen, max_new) in enumerate(trace):
        s.submit(Req(req_id=rid, prompt=[1 + rid] * plen,
                     max_new_tokens=max_new))
    log = []
    try:
        for step in range(400):
            if s.idle:
                break
            s.tick()
            admitted = s.admit_waiting()
            log.append(("admit", [(sl.slot_id, sl.req.req_id)
                                  for sl in admitted]))
            for sl in admitted:
                s.post_decode(sl, token=(step + sl.slot_id) % 5)
            active = s.pre_decode()
            log.append(("decode",
                        [(sl.slot_id, sl.req.req_id, sl.req.context_len)
                         for sl in active], s.preemptions,
                        sorted((k, list(v))
                               for k, v in s.alloc.tables.items()),
                        s.alloc.n_free))
            for sl in active:
                s.post_decode(sl, token=(3 * step + sl.slot_id) % 5)
    except AttributeError as e:
        # the reference's fault (ROADMAP C6): a victim preempted ahead of
        # its own turn in `pre_decode`'s loop is extended with no request
        log.append(("raised", str(e)))
    log.append(("finished", [(r.req_id, list(r.generated), list(r.prompt))
                             for r in s.finished], s.stats()))
    return log


@settings(max_examples=25, deadline=None)
@given(trace=st.lists(st.tuples(st.integers(1, 20), st.integers(1, 12)),
                      min_size=1, max_size=10),
       n_blocks=st.integers(8, 24), block=st.sampled_from([2, 4, 8]),
       max_batch=st.integers(1, 4), eos_id=st.sampled_from([-1, 4]))
def test_scheduler_logs_equal_the_reference(trace, n_blocks, block,
                                            max_batch, eos_id):
    max_blocks = -(-32 // block) + 1
    args = (trace, n_blocks, block, max_blocks, max_batch, eos_id)
    assert scheduler_log(Scheduler, Request, PoolConfig, *args) == \
        scheduler_log(RScheduler, RRequest, RPoolConfig, *args)


@pytest.mark.parametrize("trace,raises", [
    ([(9, 10), (13, 4), (17, 9), (18, 5), (3, 10), (2, 7)], False),
    ([(5, 10), (3, 11), (6, 9)], True),
])
def test_scheduler_preempting_trace_equals_the_reference(trace, raises):
    """Fixed traces that preempt: one where the youngest request is the
    one that ran out (everything finishes), one where an older request
    ran out first and both schedulers raise (ROADMAP C6)."""
    args = (trace, 14 if not raises else 4, 4, 8, 3, -1)
    log = scheduler_log(Scheduler, Request, PoolConfig, *args)
    assert log == scheduler_log(RScheduler, RRequest, RPoolConfig, *args)
    stats = log[-1][-1]
    assert stats["preemptions"] > 0
    assert (log[-2][0] == "raised") == raises
    assert raises or stats["finished"] == len(trace)


# ---------------------------------------------------------------------------
# engine against the reference engine
# ---------------------------------------------------------------------------

def trace_requests(Req, lengths, seed=8, vocab=512):
    rng = np.random.default_rng(seed)
    return [Req(req_id=i, prompt=rng.integers(1, vocab, plen).tolist(),
                max_new_tokens=max_new)
            for i, (plen, max_new) in enumerate(lengths)]


def both_engines(ecfg_kw, lengths, use_kernels, seed=8):
    """Greedy tokens and scheduler stats of the reference engine and the
    port's on the same parameters and requests (float32 reduced
    granite)."""
    rc, tc = configs("granite-8b", "float32")
    ref, port = shared_params(rc, tc)
    reng = REngine(rc, ref, REngineConfig(**ecfg_kw))
    want = reng.run(trace_requests(RRequest, lengths, seed))
    eng = Engine(tc, port, EngineConfig(**ecfg_kw), use_kernels=use_kernels)
    got = eng.run(trace_requests(Request, lengths, seed))
    return eng, got, reng.sched.stats(), want, eng.sched.stats()


@pytest.mark.parametrize("use_kernels", KERNEL_ROUTES)
def test_engine_greedy_tokens_equal_the_reference_with_preemption(
        use_kernels):
    """Mixed prompt lengths (buckets 2-32), more requests than slots, a
    pool too small for all of them: the same tokens, preemptions and
    steps as the reference's engine."""
    lengths = [(9, 10), (13, 4), (17, 9), (18, 5), (3, 10), (2, 7)]
    eng, got, rstats, want, stats = both_engines(
        dict(max_batch=3, max_context=32, block_size=4, pool_blocks=14),
        lengths, use_kernels)
    assert got == want
    assert stats == rstats and stats["preemptions"] > 0
    # one prefill a request and one more a preemption, in buckets
    assert len(eng.prefill_times) == len(lengths) + stats["preemptions"]
    assert {b for b, _ in eng.prefill_times} <= {1, 2, 4, 8, 16, 32}
    assert len(eng.decode_times) > 0


@pytest.mark.parametrize("use_kernels", KERNEL_ROUTES)
def test_engine_idle_slots_past_max_context_equal_the_reference(
        use_kernels):
    """A pool that holds one request at a time: two slots stay idle
    while three requests run one after another, so their pos passes
    max_context (writes dropped, the whole cache attended, as in the
    reference); tokens still equal the reference's."""
    lengths = [(9, 6), (8, 7), (10, 5), (9, 6)]
    eng, got, rstats, want, stats = both_engines(
        dict(max_batch=3, max_context=16, block_size=4, pool_blocks=4),
        lengths, use_kernels)
    assert got == want and stats == rstats
    pos = eng.cache["pos"].tolist()
    assert max(pos) > 16 and len(got) == len(lengths)


# ---------------------------------------------------------------------------
# mirrors of the reference's engine tests, on the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", KERNEL_ROUTES)
def test_engine_matches_single_request_decode(use_kernels):
    """Greedy generation through the batched engine equals running the
    same request alone (per-slot positions, cache isolation)."""
    cfg = CONFIGS["stablelm-1.6b"].reduced()
    ecfg = EngineConfig(max_batch=3, max_context=64, block_size=8)
    eng = make_engine(cfg, ecfg=ecfg, device="cpu", use_kernels=use_kernels)
    prompts = [[5, 6, 7], [9, 10, 11, 12, 13], [2, 3]]
    batched = eng.run([Request(req_id=i, prompt=p, max_new_tokens=5)
                       for i, p in enumerate(prompts)])
    for i, p in enumerate(prompts):
        solo = Engine(cfg, eng.params, EngineConfig(
            max_batch=1, max_context=64, block_size=8),
            use_kernels=use_kernels).run(
            [Request(req_id=0, prompt=list(p), max_new_tokens=5)])
        assert batched[i] == solo[0], f"request {i} diverged"


@pytest.mark.parametrize("use_kernels", KERNEL_ROUTES)
def test_engine_more_requests_than_slots(use_kernels):
    cfg = CONFIGS["stablelm-1.6b"].reduced()
    eng = make_engine(cfg, ecfg=EngineConfig(max_batch=2, max_context=32,
                                             block_size=8),
                      device="cpu", use_kernels=use_kernels)
    out = eng.run([Request(req_id=i, prompt=[1 + i, 2], max_new_tokens=3)
                   for i in range(5)])
    assert len(out) == 5
    assert all(len(v) == 3 for v in out.values())


def test_engine_temperature_sampling_is_seeded():
    cfg = CONFIGS["granite-8b"].reduced()
    params = treg.get_model(cfg).init(torch.Generator().manual_seed(3),
                                      "cpu")

    def run(seed):
        eng = Engine(cfg, params, EngineConfig(
            max_batch=2, max_context=32, block_size=8, temperature=1.5,
            seed=seed))
        return eng.run([Request(req_id=i, prompt=[3 + i, 9, 4],
                                max_new_tokens=8) for i in range(3)])

    a = run(0)
    assert a == run(0) and a != run(1)
    assert all(0 <= t < cfg.vocab for v in a.values() for t in v)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_on_the_cpu_when_asked(capsys):
    """`--device cpu`: every request finishes with its budget, and the
    scheduler's statistics equal the reference launcher's on the same
    trace (they depend on lengths only)."""
    argv = ["--arch", "stablelm-1.6b", "--reduced", "--requests", "6",
            "--max-new", "5", "--max-batch", "2"]
    out, stats = tlaunch.main(argv + ["--device", "cpu"])
    _, rstats = rlaunch.main(argv)
    reqs = tlaunch.synthetic_requests(6, CONFIGS["stablelm-1.6b"].vocab, 5)
    assert {r.req_id: r.max_new_tokens for r in reqs} == \
        {rid: len(v) for rid, v in out.items()}
    assert stats == rstats
    assert [(r.prompt, r.max_new_tokens) for r in reqs] == [
        (r.prompt, r.max_new_tokens)
        for r in rlaunch.synthetic_requests(
            6, CONFIGS["stablelm-1.6b"].vocab, 5)]
    assert "on cpu" in capsys.readouterr().out


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "granite-8b", "--reduced"])


def test_engine_refuses_unported_configs():
    cfg = CONFIGS["whisper-large-v3"].reduced()
    with pytest.raises(NotImplementedError, match="decoder-only archs"):
        make_engine(cfg, device="cpu")
    dense = CONFIGS["granite-8b"].reduced()
    params = treg.get_model(dense).init(None, "cpu")
    with pytest.raises(NotImplementedError, match="decoder-only archs"):
        Engine(dataclasses.replace(cfg), params, EngineConfig())
