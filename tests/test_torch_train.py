"""Parity of the port's training path (`repro_torch.train`, `optim`,
`models.convert`, `checkpoint`, `launch.train`) with the reference's on
the CPU.

Both packages train from the same parameters (`_lm_parity`: the
reference's seeded tree, biases and norms perturbed) on the same
batches.  The reference's step is jitted, as its launcher runs it.
Tolerances:
  * float32: loss rtol 1e-5, grad_norm rtol 1e-4, gradients within 1e-4
    of each leaf's max |g|, params rtol 1e-4 / atol 1e-6, optimizer
    state within 1e-4 of each leaf's max |value| (Adafactor's bfloat16
    accumulators, which one rounding of a float32 sum's last bit moves
    by a bfloat16 ulp, also within 2^-7 of each value: two ulps);
  * bfloat16: the reference test's bars (`tests/test_train_loop.py`):
    loss rel 1e-3, params rtol 5e-2 / atol 5e-3; state within 5e-2 of
    each leaf's max |value|.
Excluded, and named by `sign_noise`: parameter elements whose first
update follows rounding noise.  AdamW's first step on an element (the
first step whose gradient there is nonzero: an embedding row waits for
its token) moves it by about lr·g/(|g| + eps): where the gradient (the
port's, within 1e-5 of the leaf's max of the reference's) is then below
max(1e-6 of its leaf's max |g|, 100·eps = 1e-6),
that quotient depends on g's last bits (or its sign), so the packages
may step apart by up to lr (about 300 of the reduced models' 427,000
elements; exact zeros, the unused embedding rows, stay in).
The same elements are excluded under Adafactor, whose first update has
no such noise; everywhere else the bars hold.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import configs, f32, shared_train_params, train_batch

from repro.models import registry as rreg
from repro.optim import OptimizerConfig as ROptimizerConfig
from repro.optim import make_optimizer as r_make_optimizer
from repro.train import loop as rloop
from repro_torch.configs import CONFIGS
from repro_torch.kernels import ops
from repro_torch.models import convert, registry as treg
from repro_torch.models.registry import get_model, random_train_batch
from repro_torch.optim import OptimizerConfig, make_optimizer
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    loss_and_grads, make_train_step)
from repro_torch.tree import leaves, tree_map

ARCHS = ["stablelm-1.6b", "granite-8b"]
DTYPES = ["float32", "bfloat16"]
OPTS = ["adamw", "adafactor"]
N_STEPS = 3
BATCH, SEQ = 4, 16
TOL = {"float32": dict(loss=1e-5, gnorm=1e-4, rtol=1e-4, atol=1e-6,
                       state=1e-4),
       "bfloat16": dict(loss=1e-3, gnorm=1e-2, rtol=5e-2, atol=5e-3,
                        state=5e-2)}
SIGN_NOISE = 1e-6          # of a leaf's max |g|
NOISE_FLOOR = 100 * 1e-8   # 100 x the optimizers' eps


@pytest.fixture(autouse=True)
def one_thread():
    """These models are tiny: one intra-op thread a test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt_kw(name):
    return dict(name=name, lr=1e-3, warmup_steps=2, total_steps=100)


def _batches(vocab):
    return [train_batch(vocab, BATCH, SEQ, seed=10 + s)
            for s in range(N_STEPS)]


def _copy(t):
    """A float32 numpy copy of a port leaf (the step updates it in
    place)."""
    return np.array(f32(t), copy=True)


@functools.lru_cache(maxsize=None)
def runs(arch, dtype, accum, opt):
    """N_STEPS steps in both packages from the same state: per step the
    port's gradients, and the reference's and the port's (metrics,
    params, state, step), as numpy."""
    rc, tc = configs(arch, dtype)
    rparams, tparams = shared_train_params(rc)
    rtc = rloop.TrainConfig(optimizer=ROptimizerConfig(**_opt_kw(opt)),
                            remat="none", accum_steps=accum)
    ttc = TrainConfig(optimizer=OptimizerConfig(**_opt_kw(opt)),
                      remat="none", accum_steps=accum)
    rapi, tapi = rreg.get_model(rc), treg.get_model(tc)
    rstate = r_make_optimizer(rtc.optimizer)[0](rparams)
    tstate = make_optimizer(ttc.optimizer)[0](tparams)
    rstep = jax.jit(rloop.make_train_step(rapi, rtc))
    tstep = make_train_step(tapi, ttc)
    tgrad = loss_and_grads(tapi, "none")
    out = {"grads": [], "ref": [], "port": [],
           "state_bf16": [a.dtype == jnp.bfloat16
                          for a in jax.tree.leaves(rstate[1:])]}
    for rb, tb in _batches(tc.vocab):
        out["grads"].append([_copy(g) for g in leaves(tgrad(tparams, tb)[1])])
        rparams, rstate, rm = rstep(rparams, rstate, rb)
        tparams, tstate, tm = tstep(tparams, tstate, tb)
        out["ref"].append(({k: float(v) for k, v in rm.items()},
                           [f32(a) for a in jax.tree.leaves(rparams)],
                           [f32(a) for a in jax.tree.leaves(rstate[1:])],
                           int(rstate.step)))
        out["port"].append(({k: float(v) for k, v in tm.items()},
                            [_copy(a) for a in leaves(tparams)],
                            [_copy(a) for a in leaves(tuple(tstate[1:]))],
                            int(tstate.step)))
    return out


def sign_noise(grads_by_step):
    """Per parameter leaf: the elements whose first update (at the first
    step with a nonzero gradient there) follows rounding noise: 0 < |g|
    below SIGN_NOISE of the leaf's max at that step, or below
    NOISE_FLOOR."""
    masks, seen = None, None
    for grads in grads_by_step:
        tiny = [(g != 0) & (np.abs(g) < max(SIGN_NOISE * np.abs(g).max(),
                                            NOISE_FLOOR)) for g in grads]
        if masks is None:
            masks, seen = tiny, [g != 0 for g in grads]
            continue
        masks = [m | (t & ~s) for m, t, s in zip(masks, tiny, seen)]
        seen = [s | (g != 0) for s, g in zip(seen, grads)]
    return masks


CASES = [(arch, dtype, accum, opt) for arch in ARCHS for dtype in DTYPES
         for accum in (1, 2) for opt in OPTS]


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
@pytest.mark.parametrize("arch,dtype,accum,opt", CASES)
def test_train_steps_match_the_reference(arch, dtype, accum, opt, n_steps):
    r = runs(arch, dtype, accum, opt)
    tol = TOL[dtype]
    rm, rp, rs, rstep = r["ref"][n_steps - 1]
    tm, tp, ts, tstep = r["port"][n_steps - 1]
    assert tstep == rstep == n_steps
    assert tm["lr"] == rm["lr"]                      # the schedule, exact
    np.testing.assert_allclose(tm["loss"], rm["loss"], rtol=tol["loss"])
    np.testing.assert_allclose(tm["grad_norm"], rm["grad_norm"],
                               rtol=tol["gnorm"])
    noise = sign_noise(r["grads"][:n_steps])
    assert len(tp) == len(rp) == len(noise)
    for got, want, skip in zip(tp, rp, noise):
        keep = ~skip
        np.testing.assert_allclose(got[keep], want[keep], rtol=tol["rtol"],
                                   atol=tol["atol"])
    assert len(ts) == len(rs)
    for got, want, bf16 in zip(ts, rs, r["state_bf16"]):
        assert got.shape == want.shape
        bound = tol["state"] * max(np.abs(want).max(), 1e-30)
        if bf16:
            bound = bound + 2.0 ** -7 * np.abs(want)
        assert (np.abs(got - want) <= bound).all()


# ---------------------------------------------------------------------------
# gradients and activation recomputation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_reference(arch):
    """float32: the loss within rtol 1e-5, every gradient leaf within 1e-4
    of its max |g|, in the reference's leaf order."""
    rc, tc = configs(arch, "float32")
    rparams, tparams = shared_train_params(rc)
    rb, tb = train_batch(tc.vocab, BATCH, SEQ, seed=3)
    rloss, rgrads = jax.value_and_grad(
        lambda p: rreg.get_model(rc).loss_fn(p, rb, remat="none"))(rparams)
    tloss, tgrads = loss_and_grads(treg.get_model(tc), "none")(tparams, tb)
    np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-5)
    want = jax.tree.leaves(rgrads)
    got = leaves(tgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        w = f32(w)
        assert np.abs(f32(g) - w).max() <= 1e-4 * np.abs(w).max()


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", DTYPES)
def test_remat_modes_give_the_same_loss_and_grads(dtype):
    """none / dots / full: bit-equal loss and gradients; the backward
    recomputes what each mode drops -- "dots" the batched attention
    products only, "full" the weight GEMMs too."""
    _, tc = configs("stablelm-1.6b", dtype)
    api = treg.get_model(tc)
    params, _ = init_train_state(api, TrainConfig(),
                                 torch.Generator().manual_seed(0), "cpu")
    _, tb = train_batch(tc.vocab, 2, SEQ, seed=4)
    out, backward_ops = {}, {}
    for mode in ("none", "dots", "full"):
        live = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = api.loss_fn(convert.params_from_reference(live, tc, "cpu"),
                           tb, remat=mode, use_kernels=False)
        with _CountOps() as ops_seen:
            grads = torch.autograd.grad(loss, leaves(live))
        out[mode] = (loss, grads)
        backward_ops[mode] = ops_seen.counts
    for mode in ("dots", "full"):
        assert torch.equal(out[mode][0], out["none"][0])
        assert all(torch.equal(a, b)
                   for a, b in zip(out[mode][1], out["none"][1]))
    assert backward_ops["dots"]["mm"] == backward_ops["none"]["mm"]
    assert backward_ops["dots"]["bmm"] > backward_ops["none"]["bmm"]
    assert backward_ops["full"]["mm"] > backward_ops["none"]["mm"]
    assert backward_ops["full"]["bmm"] == backward_ops["dots"]["bmm"]
    with pytest.raises(ValueError, match="remat"):
        api.loss_fn(convert.params_from_reference(params, tc, "cpu"), tb,
                    remat="some", use_kernels=False)


# ---------------------------------------------------------------------------
# the kernels have no backward
# ---------------------------------------------------------------------------

def test_a_gradient_through_the_kernel_path_raises():
    _, tc = configs("stablelm-1.6b", "float32")
    api = treg.get_model(tc)
    params, _ = init_train_state(api, TrainConfig(),
                                 torch.Generator().manual_seed(0), "cpu")
    _, tb = train_batch(tc.vocab, 2, SEQ, seed=5)
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    port = convert.params_from_reference(live, tc, "cpu")
    for remat in ("none", "full"):
        with pytest.raises(RuntimeError, match="no backward"):
            api.loss_fn(port, tb, remat=remat, use_kernels=True)
    with torch.no_grad():
        want = api.loss_fn(port, tb, use_kernels=False)
        got = api.loss_fn(port, tb, use_kernels=True)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_the_attention_ops_refuse_grad_and_run_without_it():
    g = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn(1, 2, 16, 64, generator=g) for _ in range(3))
    want = ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert torch.equal(ops.flash_attention(q, k, v), want)
    with torch.inference_mode():
        assert torch.equal(ops.flash_attention(q.detach(), k, v), want)
    pool = torch.randn(4, 16, 2, 64, generator=g)
    qd = torch.randn(2, 4, 64, generator=g)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    lengths = torch.tensor([20, 32], dtype=torch.int32)
    want = ops.paged_attention(qd, pool, pool, tables, lengths)
    with pytest.raises(RuntimeError, match="paged_attention.*no backward"):
        ops.paged_attention(qd, pool.requires_grad_(), pool, tables,
                            lengths)
    with torch.no_grad():
        assert torch.equal(
            ops.paged_attention(qd, pool, pool, tables, lengths), want)


# ---------------------------------------------------------------------------
# mirrors of the reference's train-loop tests (tests/test_train_loop.py)
# ---------------------------------------------------------------------------

def _setup(accum=1, lr=1e-3):
    cfg = CONFIGS["stablelm-1.6b"].reduced()
    api = get_model(cfg)
    tc = TrainConfig(optimizer=OptimizerConfig(lr=lr, warmup_steps=1,
                                               total_steps=100),
                     remat="none", accum_steps=accum)
    params, opt = init_train_state(api, tc, torch.Generator().manual_seed(0),
                                   "cpu")
    return cfg, api, tc, params, opt


def test_accumulation_matches_single_batch():
    """accum=2 over a batch == accum=1 over the same batch (same update)."""
    cfg, api, tc1, params, opt = _setup(accum=1)
    _, _, tc2, params2, opt2 = _setup(accum=2)
    batch = random_train_batch(cfg, 4, 16, device="cpu")
    p1, _, m1 = make_train_step(api, tc1)(params, opt, batch)
    p2, _, m2 = make_train_step(api, tc2)(params2, opt2, batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(f32(a), f32(b), rtol=5e-2, atol=5e-3)


def test_loss_descends_on_learnable_data():
    """Fixed repeating batch -> the model must memorize it."""
    cfg, api, tc, params, opt = _setup(lr=3e-3)
    step = make_train_step(api, tc)
    batch = random_train_batch(cfg, 2, 16, seed=1, device="cpu")
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_metrics_contract():
    cfg, api, tc, params, opt = _setup()
    batch = random_train_batch(cfg, 2, 16, device="cpu")
    _, _, metrics = make_train_step(api, tc)(params, opt, batch)
    assert set(metrics) >= {"loss", "grad_norm", "lr"}
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_a_step_frees_what_its_caller_drops():
    """Dropping a step's state and outputs frees every tensor the step
    made at once, without waiting for the garbage collector: no
    reference cycle holds its parameters, moments or gradients (one,
    through `tree.unflatten`, held a step's gradients until a
    collection)."""
    import gc

    def tensors():
        return {id(o): o.numel() for o in gc.get_objects()
                if isinstance(o, torch.Tensor)}

    cfg, api, tc, params, opt = _setup()
    batch = random_train_batch(cfg, 2, 16, device="cpu")
    step = make_train_step(api, tc)
    gc.collect()
    gc.disable()
    try:
        before = tensors()
        out = step(params, opt, batch)
        del params, opt, out
        left = {k: n for k, n in tensors().items() if k not in before}
    finally:
        gc.enable()
    assert sum(left.values()) == 0, f"{len(left)} tensors outlive the step"


def test_params_round_trip_between_layouts():
    """params_to_reference restacks the port's layers (head row-major)
    and params_from_reference gives views of the stacks back."""
    cfg = CONFIGS["granite-8b"].reduced()
    api = get_model(cfg)
    port = api.init(torch.Generator().manual_seed(1), "cpu")
    ref = convert.params_to_reference(port, cfg)
    assert ref["head"].is_contiguous() and ref["prefix"] == []
    assert ref["stacks"][0]["attn"]["wq"].shape == \
        (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)
    back = convert.params_from_reference(ref, cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(port)))
    wq = back["layers"][1]["attn"]["wq"]
    assert wq.data_ptr() == ref["stacks"][0]["attn"]["wq"][1].data_ptr()
