"""The port's optimizers and gradient compression (`repro_torch.optim`)
against the reference's (`repro.optim`) on the CPU, and the reference's
own optimizer tests (`tests/test_optim.py`) mirrored on the port.

Updates start from the same params, grads and state (numpy, made from a
seed): the step's first update, a warmup step and a step after warmup,
with the global-norm clip active and inactive, float32 and bfloat16
params, leaves of 1, 2 and 3 dims.  Float32 params and state agree
within rtol 1e-6, atol 1e-6 of the leaf's max |value| (an element that
the step takes near 0 keeps the absolute rounding of its operands, about
half a float32 ulp of the leaf's scale); bfloat16 params and
accumulators within one bfloat16 ulp (the float32 result rounded once,
either way of a tie the float32 step's last bits decide).  `cosine_lr`
is bit for bit.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptimizerConfig as ROptimizerConfig
from repro.optim import adafactor_update as r_adafactor_update
from repro.optim import adamw_update as r_adamw_update
from repro.optim import cosine_lr as r_cosine_lr
from repro.optim import grad_compress as rgc
from repro.optim.adamw import AdafactorState as RAdafactorState
from repro.optim.adamw import AdamWState as RAdamWState
from repro_torch.device import to_tensor
from repro_torch.launch import steps as tsteps
from repro_torch.optim import (AdafactorState, AdamWState, OptimizerConfig,
                               adafactor_init, adafactor_update, adamw_init,
                               adamw_update, cosine_lr, make_optimizer,
                               optimizer_bytes_per_param)
from repro_torch.optim.grad_compress import (CompressionState,
                                             compress_grads, compress_init,
                                             crosspod_allreduce_compressed,
                                             decompress_grads,
                                             dequantize_int8, quantize_int8)
from repro_torch.tree import leaves, tree_map

SHAPES = {"w": (8, 16), "stack": (3, 8, 16), "b": (16,), "vec": (3, 16)}
SCHEDULES = [dict(lr=3e-4, warmup_steps=2000, total_steps=100_000),
             dict(lr=1e-3, warmup_steps=1, total_steps=100),
             dict(lr=3e-3, warmup_steps=2, total_steps=12),
             dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_cosine_lr_is_the_references_bit_for_bit(kw):
    ref, port = ROptimizerConfig(**kw), OptimizerConfig(**kw)
    steps = list(range(0, 260)) + list(range(260, kw["total_steps"] + 50,
                                             max(1, kw["total_steps"] // 997)))
    for s in steps:
        want = np.asarray(r_cosine_lr(ref, jnp.int32(s)))
        got = cosine_lr(port, s)
        assert got.dtype == torch.float32
        assert got.numpy().tobytes() == want.tobytes(), s


def _tree(rng, dtype, scale=1.0):
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _both(tree, dtype):
    """(jnp tree, port tensor tree) of the same values in `dtype`."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = {k: jnp.asarray(v, jdt) for k, v in tree.items()}
    port = {k: to_tensor(np.asarray(v), "cpu").clone()
            for k, v in ref.items()}
    return ref, port


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _state(name, rng, params, step):
    """A seeded optimizer state at `step` in both packages."""
    if name == "adamw":
        mu = {k: rng.normal(size=s).astype(np.float32) * 0.01
              for k, s in SHAPES.items()}
        nu = {k: rng.uniform(1e-6, 1e-3, size=s).astype(np.float32)
              for k, s in SHAPES.items()}
        ref = RAdamWState(jnp.int32(step), *(jax.tree.map(jnp.asarray, t)
                                             for t in (mu, nu)))
    else:
        def stat(shape_of):
            return {k: jnp.asarray(rng.uniform(1e-6, 1e-3, size=shape_of(s))
                                   .astype(np.float32), jnp.bfloat16)
                    for k, s in SHAPES.items()}
        ref = RAdafactorState(
            jnp.int32(step),
            stat(lambda s: s[:-1] if len(s) >= 2 else ()),
            stat(lambda s: s[:-2] + s[-1:] if len(s) >= 2 else ()),
            stat(lambda s: () if len(s) >= 2 else s))
    cls = AdamWState if name == "adamw" else AdafactorState
    port = cls(torch.tensor(step, dtype=torch.int32),
               *(tree_map(lambda a: to_tensor(np.asarray(a), "cpu").clone(),
                          t) for t in ref[1:]))
    return ref, port


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("step", [0, 1, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_matches_the_reference(name, dtype, step, clip):
    """`step` is the state's count before the update: 0 (the first),
    1 (in warmup: warmup_steps 5), 50 (after warmup)."""
    rng = np.random.default_rng(zlib.crc32(f"{name} {dtype} {step} {clip}"
                                           .encode()))
    kw = dict(name=name, lr=1e-2, warmup_steps=5, total_steps=100,
              grad_clip=1.0 if clip == "active" else 1e6)
    rp, tp = _both(_tree(rng, dtype), dtype)
    rg, tg = _both(_tree(rng, dtype, scale=0.5), dtype)
    rs, ts = _state(name, rng, rp, step)
    rupd = r_adamw_update if name == "adamw" else r_adafactor_update
    tupd = adamw_update if name == "adamw" else adafactor_update
    rp2, rs2, rm = rupd(ROptimizerConfig(**kw), rg, rs, rp)
    tp2, ts2, tm = tupd(OptimizerConfig(**kw), tg, ts, tp)
    assert int(ts2.step) == int(rs2.step) == step + 1
    assert tm["lr"].numpy().tobytes() == np.asarray(rm["lr"]).tobytes()
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-6)
    assert (float(rm["grad_norm"]) > kw["grad_clip"]) == (clip == "active")
    for key in SHAPES:
        got, want = _f32(tp2[key]), _f32(rp2[key])
        assert tp2[key].dtype == tp[key].dtype
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        else:       # one bfloat16 ulp: 2^-7 of the value's binade
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert (np.abs(got - want) <= ulp).all(), key
    for got_t, want_t in zip(leaves(tuple(ts2[1:])),
                             jax.tree.leaves(tuple(rs2[1:]))):
        assert str(got_t.dtype).replace("torch.", "") == str(want_t.dtype)
        got, want = _f32(got_t), _f32(want_t)
        if got_t.dtype == torch.bfloat16:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      1e-30))) - 7)
            assert (np.abs(got - want) <= ulp).all()
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


def test_updates_write_the_state_in_place():
    params = {"w": torch.zeros(4, 4), "b": torch.ones(4)}
    for name in ("adamw", "adafactor"):
        init, update = make_optimizer(OptimizerConfig(name=name))
        state = init(params)
        grads = tree_map(torch.ones_like, params)
        new_params, new_state, _ = update(grads, state, params)
        assert new_params is params
        assert all(a is b for a, b in zip(leaves(tuple(new_state[1:])),
                                          leaves(tuple(state[1:]))))
        assert new_state.step.device.type == "cpu"


def test_optimizer_for_and_bytes_per_param():
    from repro.launch import steps as rsteps
    from repro.configs import CONFIGS as R_CONFIGS
    from repro_torch.configs import CONFIGS
    assert tsteps.ADAFACTOR_THRESHOLD == rsteps.ADAFACTOR_THRESHOLD
    for arch in CONFIGS:
        want = rsteps.optimizer_for(R_CONFIGS[arch])
        assert tsteps.optimizer_for(CONFIGS[arch]).name == want.name
    assert optimizer_bytes_per_param("adamw") == 8.0
    assert optimizer_bytes_per_param("adafactor") == 2.1


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_compression_matches_the_reference():
    """int8 payloads equal, scales within rtol 1e-7, residuals and the
    decompressed gradients equal, over a few error-feedback rounds."""
    rng = np.random.default_rng(3)
    shapes = {"a": (64, 33), "b": (7,), "c": (2, 3, 5)}
    grads = [{k: (rng.normal(size=s) * 10 ** rng.uniform(-3, 1))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    rstate = rgc.compress_init(jax.tree.map(jnp.asarray, grads[0]))
    tstate = compress_init({k: torch.from_numpy(v)
                            for k, v in grads[0].items()})
    for g in grads:
        rp, rs, rstate = rgc.compress_grads(jax.tree.map(jnp.asarray, g),
                                            rstate)
        tp, ts, tstate = compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, tstate)
        for k in shapes:
            assert tp[k].dtype == torch.int8
            assert np.array_equal(tp[k].numpy(), np.asarray(rp[k]))
            np.testing.assert_allclose(float(ts[k]), float(rs[k]),
                                       rtol=1e-7)
            np.testing.assert_allclose(tstate.residual[k].numpy(),
                                       np.asarray(rstate.residual[k]),
                                       rtol=1e-6, atol=1e-7 * float(rs[k]))
        rd = rgc.decompress_grads(rp, rs)
        td = decompress_grads(tp, ts)
        for k in shapes:
            np.testing.assert_allclose(td[k].numpy(), np.asarray(rd[k]),
                                       rtol=1e-6)


def test_crosspod_allreduce_waits_for_the_distributed_slice():
    """The all-reduce runs inside a shard_map body over the mesh's pod
    axis (held against the reference in tests/test_torch_collectives.py);
    outside one the axis is unbound, as in JAX."""
    g = {"g": torch.zeros(4)}
    with pytest.raises(NameError, match="unbound axis name: 'pod'"):
        crosspod_allreduce_compressed(g, compress_init(g))


# ---------------------------------------------------------------------------
# mirrors of tests/test_optim.py
# ---------------------------------------------------------------------------

def _quadratic_target():
    w_star = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 8))
                              .astype(np.float32))

    def loss(params):
        return torch.sum((params["w"] - w_star) ** 2)

    return loss, w_star


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_converge_on_quadratic(name):
    loss, w_star = _quadratic_target()
    cfg = OptimizerConfig(name=name, lr=0.05, weight_decay=0.0,
                          warmup_steps=1, total_steps=400)
    init, update = make_optimizer(cfg)
    params = {"w": torch.zeros((8, 8), dtype=torch.float32)}
    state = init(params)
    l0 = float(loss(params))
    for _ in range(300):
        w = params["w"].detach().requires_grad_()
        grads = {"w": torch.autograd.grad(loss({"w": w}), w)[0]}
        params, state, _ = update(grads, state, params)
    assert float(loss(params)) < 0.01 * l0


def test_cosine_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    lrs = [float(cosine_lr(cfg, s)) for s in range(0, 101, 10)]
    assert lrs[1] == pytest.approx(1.0, rel=1e-3)         # end of warmup
    assert lrs[-1] == pytest.approx(0.1, rel=1e-2)        # min_lr floor
    assert all(a >= b - 1e-6 for a, b in zip(lrs[1:], lrs[2:]))


def test_adamw_moments_fp32():
    params = {"w": torch.zeros((4,), dtype=torch.bfloat16)}
    st = adamw_init(params)
    assert st.mu["w"].dtype == torch.float32


def test_adafactor_memory_is_factored():
    params = {"w": torch.zeros((64, 32), dtype=torch.bfloat16)}
    st = adafactor_init(params)
    assert st.vr["w"].shape == (64,)
    assert st.vc["w"].shape == (32,)


def test_quantize_roundtrip_bounded_error():
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, s = quantize_int8(g)
    err = torch.abs(dequantize_int8(q, s) - g)
    assert float(err.max()) <= float(s) * 0.5 + 1e-6


def test_error_feedback_keeps_running_sum():
    """Error feedback: the cumulative transmitted signal tracks the
    cumulative true gradient (bias -> 0)."""
    rng = np.random.default_rng(2)
    grads = [{"g": torch.from_numpy(rng.normal(size=(64,))
                                    .astype(np.float32))}
             for _ in range(50)]
    state = compress_init(grads[0])
    sent_sum = np.zeros(64, np.float32)
    true_sum = np.zeros(64, np.float32)
    for g in grads:
        payload, scales, state = compress_grads(g, state)
        sent = decompress_grads(payload, scales)
        sent_sum += sent["g"].numpy()
        true_sum += g["g"].numpy()
    resid = np.abs(sent_sum - true_sum).max()
    assert resid <= float(state.residual["g"].abs().max()) + 1e-4
    assert isinstance(state, CompressionState)


def test_compression_ratio():
    g = {"g": torch.zeros((1024,), dtype=torch.float32)}
    payload, scales, _ = compress_grads(g, compress_init(g))
    assert payload["g"].dtype == torch.int8 and scales["g"].numel() == 1
    raw = 1024 * 4
    sent = payload["g"].numel() * 1 + 4
    assert sent / raw < 0.26          # ~3.9x fewer DCN bytes
