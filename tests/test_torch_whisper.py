"""Parity of the port's encoder-decoder (`repro_torch.models.whisper`)
with the reference's (`repro.models.whisper`) on the CPU, at the reduced
Whisper-large-v3 config (2 + 2 layers, d 128, 4 / 2 heads of 32,
decoder_len 32) and at the same widths with decoder_len 448.

Both packages get the same parameters and inputs (`_lm_parity.py`).
Outputs hold within `TOL` (float32 rtol 1e-4 / atol 1e-5; bfloat16 the
reference's cache-against-forward bar, rtol = atol = 0.08) on both
routes: `use_kernels=True` runs the flash and paged kernels' plain
versions here (flash on the divisor blocks of 150 frames -> 75, 160 ->
80 and of a 228-token prompt -> 114; paged over the cross K/V read as
2-token blocks at 150 frames, 16-token ones at 160 and 4-token ones at
1,500), `use_kernels=False` the transcribed
`_sdpa_chunked`.  Gradients: every float32 leaf within 1e-4 of its max.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import (TOL, configs, f32, frames, shared_params,
                        shared_train_params)

from repro.models import registry as rreg, whisper as rwh
from repro.optim import OptimizerConfig as ROptimizerConfig
from repro.train import loop as rloop
from repro_torch.configs import CONFIGS
from repro_torch.launch import serve as tlaunch
from repro_torch.models import common as tcommon, convert
from repro_torch.models import registry as treg, transformer as ttr
from repro_torch.models import whisper as twh
from repro_torch.optim import OptimizerConfig
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve.engine import make_engine
from repro_torch.train.loop import TrainConfig, loss_and_grads, \
    make_train_step
from repro_torch.tree import leaves

ARCH = "whisper-large-v3"
DTYPES = ["float32", "bfloat16"]
ROUTES = [True, False]
N_FRAMES = 150          # flash blocks of 75; paged cross blocks of 2
N_DECODE_FRAMES = 160   # flash blocks of 80; paged cross blocks of 16


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny models: one intra-op thread a test worker keeps parallel
    workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def cfgs(dtype, decoder_len=None):
    rc, tc = configs(ARCH, dtype)
    if decoder_len is not None:
        rc = dataclasses.replace(rc, decoder_len=decoder_len)
        tc = dataclasses.replace(tc, decoder_len=decoder_len)
    return rc, tc


@functools.lru_cache(maxsize=None)
def params(dtype, decoder_len=None):
    return shared_params(*cfgs(dtype, decoder_len))


def tokens(tc, batch, t, seed=4):
    toks = np.random.default_rng(seed).integers(
        0, tc.vocab, (batch, t)).astype(np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks)


# ---------------------------------------------------------------------------
# the API, parameters, batches
# ---------------------------------------------------------------------------

def test_get_model_runs_whisper_and_has_the_reference_tree():
    rc, tc = cfgs("bfloat16")
    api = treg.get_model(tc)
    assert api.cfg is tc
    want = jax.eval_shape(lambda: rreg.get_model(rc).init(
        jax.random.PRNGKey(0)))
    got = convert.params_to_reference(
        api.init(torch.Generator().manual_seed(0), "cpu"), tc)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got, is_leaf=lambda t: isinstance(
            t, torch.Tensor)))
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


def test_whisper_large_v3_published_size():
    """32 + 32 layers, d 1280, 20 heads of 64, d_ff 5120, vocab 51,866:
    1,535,383,040 parameters by the reference tree's shapes."""
    cfg = CONFIGS[ARCH]
    assert (cfg.n_encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab, cfg.decoder_len) \
        == (32, 32, 1280, 20, 20, 64, 5120, 51866, 448)
    shapes = jax.eval_shape(lambda: rwh.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) \
        == 1_535_383_040


def test_convert_round_trip_is_the_reference_tree():
    """params_to_reference(params_from_reference(tree)) is the tree, the
    bfloat16 bytes unchanged; the port's layers are views of the stacks."""
    rc, tc = cfgs("bfloat16")
    ref, port = params("bfloat16")
    assert len(port["enc_layers"]) == tc.n_encoder_layers
    assert len(port["dec_layers"]) == tc.n_layers
    w = np.asarray(ref["dec_stack"]["cross_attn"]["wk"][1])
    g = port["dec_layers"][1]["cross_attn"]["wk"]
    assert g.dtype == torch.bfloat16
    assert np.array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
    back = convert.params_to_reference(port, tc)
    want = jax.tree.leaves(ref)
    got = leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(f32(g), f32(w))


def test_random_train_batch_is_the_reference_batch():
    """Frames, then tokens, then labels of min(seq, decoder_len - 8)."""
    rc, tc = cfgs("bfloat16")
    for seq in (12, 40):
        want = rreg.random_train_batch(rc, 2, seq, seed=3)
        got = treg.random_train_batch(tc, 2, seq, seed=3, device="cpu")
        assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
        assert got["tokens"].shape == (2, min(seq, tc.decoder_len - 8))
        for name in want:
            assert got[name].dtype == (torch.bfloat16 if name == "frames"
                                       else torch.int32)
            assert np.array_equal(f32(got[name]), f32(want[name]))


def test_sinusoids_are_the_reference_table():
    assert np.array_equal(twh.sinusoids(150, 128).numpy(),
                          np.asarray(rwh.sinusoids(150, 128)))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_encode(dtype):
    rc, tc = cfgs(dtype)
    rf, _ = frames(tc, 2, N_FRAMES)
    return f32(rwh.encode(params(dtype)[0], rc, rf, remat="none"))


@pytest.mark.parametrize("use_kernels", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_the_reference(dtype, use_kernels):
    """150 frames: non-causal self-attention on flash blocks of 75."""
    _, tc = cfgs(dtype)
    _, tf = frames(tc, 2, N_FRAMES)
    got = twh.encode(params(dtype)[1], tc, tf, remat="none",
                     use_kernels=use_kernels)
    assert got.dtype == tcommon.dtype_of(tc)
    np.testing.assert_allclose(f32(got), reference_encode(dtype),
                               **TOL[dtype])


@pytest.mark.parametrize("use_kernels", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_matches_the_reference(dtype, use_kernels):
    """No cache: causal self-attention over 12 tokens and cross-attention
    over the same encoder states (given to both packages)."""
    rc, tc = cfgs(dtype)
    ref, port = params(dtype)
    renc, tenc = frames(tc, 2, N_FRAMES, seed=5)
    rt, tt = tokens(tc, 2, 12)
    x, _ = rwh.decode(ref, rc, rt, renc, remat="none")
    y, cache = twh.decode(port, tc, tt, tenc, remat="none",
                          use_kernels=use_kernels)
    assert cache is None
    np.testing.assert_allclose(f32(y), f32(x), **TOL[dtype])


#: (prompt, steps, max_len, decoder_len): a short prompt; a decode past
#: decoder_len (positions 28-35 read dec_pos row 31); the 228-token
#: prompt of previous-text conditioning at decoder_len 448
DECODES = {"short": (6, 6, 16, None), "past_decoder_len": (28, 8, 40, None),
           "prompt_228": (228, 4, 448, 448)}


@functools.lru_cache(maxsize=None)
def reference_decode(dtype, case):
    plen, n_steps, max_len, dlen = DECODES[case]
    rc, tc = cfgs(dtype, dlen)
    ref, _ = params(dtype, dlen)
    rf, _ = frames(tc, 2, N_DECODE_FRAMES)
    rt, _ = tokens(tc, 2, plen + n_steps)
    prefill = jax.jit(rwh.prefill, static_argnums=(1, 3))
    step = jax.jit(rwh.decode_step, static_argnums=(1,))
    logits, cache = prefill(ref, rc, {"frames": rf, "tokens": rt[:, :plen]},
                            max_len)
    out = [f32(logits)]
    for t in range(plen, plen + n_steps):
        logits, cache = step(ref, rc, cache, rt[:, t:t + 1])
        out.append(f32(logits))
    return out, np.asarray(cache["pos"]).tolist(), \
        f32(cache["kv_stack"]["kv"]["k"]), f32(cache["kv_stack"]["kv"]["v"])


@pytest.mark.parametrize("case", sorted(DECODES))
@pytest.mark.parametrize("use_kernels", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_step_match_the_reference(dtype, use_kernels,
                                                     case):
    """Prefill (encoder, prompt into a fresh cache), then teacher-forced
    decode steps: every step's logits, the final positions and the
    stacked self K/V within `TOL` (bfloat16: the logits, and the first
    layer's K/V, whose input has not crossed a layer)."""
    plen, n_steps, max_len, dlen = DECODES[case]
    want, want_pos, want_k, want_v = reference_decode(dtype, case)
    _, tc = cfgs(dtype, dlen)
    _, port = params(dtype, dlen)
    _, tf = frames(tc, 2, N_DECODE_FRAMES)
    _, tt = tokens(tc, 2, plen + n_steps)
    logits, cache = twh.prefill(port, tc, {"frames": tf,
                                           "tokens": tt[:, :plen]},
                                max_len, use_kernels=use_kernels)
    got = [f32(logits)]
    for t in range(plen, plen + n_steps):
        logits, cache = twh.decode_step(port, tc, cache, tt[:, t:t + 1],
                                        use_kernels=use_kernels)
        got.append(f32(logits))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL[dtype])
    assert cache["pos"].tolist() == want_pos
    depth = tc.n_layers if dtype == "float32" else 1
    for name, w in (("k", want_k), ("v", want_v)):
        np.testing.assert_allclose(f32(cache["kv_stack"]["kv"][name])[:depth],
                                   w[:depth], **TOL[dtype])


@pytest.mark.parametrize("use_kernels", ROUTES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_fn_matches_the_reference(dtype, use_kernels):
    rc, tc = cfgs(dtype)
    ref, port = params(dtype)
    rf, tf = frames(tc, 2, N_FRAMES)
    rt, tt = tokens(tc, 2, 16)
    labels = np.random.default_rng(7).integers(-1, tc.vocab, (2, 16))
    want = float(rwh.loss_fn(ref, rc, {"frames": rf, "tokens": rt,
                                       "labels": jnp.asarray(labels,
                                                             jnp.int32)},
                             remat="none"))
    got = treg.get_model(tc).loss_fn(
        port, {"frames": tf, "tokens": tt,
               "labels": torch.from_numpy(labels.astype(np.int32))},
        use_kernels=use_kernels)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, **TOL[dtype])


def _train_batch(tc, seed):
    """A (reference, port) batch of 40 frames and 16 tokens."""
    rf, tf = frames(tc, 2, 40, seed=seed)
    toks = np.random.default_rng(seed).integers(
        0, tc.vocab, (2, 17)).astype(np.int32)
    return ({"frames": rf, "tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])},
            {"frames": tf, "tokens": torch.from_numpy(toks[:, :-1].copy()),
             "labels": torch.from_numpy(toks[:, 1:].copy())})


def test_gradients_match_the_reference():
    """float32: `loss_fn` and its gradient in the reference's stacked
    layout (`train.loop.loss_and_grads`), every leaf within 1e-4 of its
    max |g|."""
    rc, tc = cfgs("float32")
    rparams, tparams = shared_train_params(rc)
    rb, tb = _train_batch(tc, 8)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: rreg.get_model(rc).loss_fn(p, rb, remat="none")))(rparams)
    tloss, tgrads = loss_and_grads(treg.get_model(tc), "full")(tparams, tb)
    np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-5)
    want = jax.tree.leaves(rgrads)
    got = leaves(tgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        w = f32(w)
        assert np.abs(f32(g) - w).max() <= 1e-4 * np.abs(w).max()


def test_remat_modes_give_the_same_loss_and_grads():
    """"full" recomputes each encoder and decoder layer: loss and
    gradients bit-equal to "none"."""
    rc, tc = cfgs("float32")
    _, tparams = shared_train_params(rc)
    _, tb = _train_batch(tc, 9)
    out = {mode: loss_and_grads(treg.get_model(tc), mode)(tparams, tb)
           for mode in ("none", "full")}
    assert torch.equal(out["full"][0], out["none"][0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(out["full"][1]),
                                                  leaves(out["none"][1])))


def test_train_step_matches_the_reference():
    """One `make_train_step` step (AdamW, float32) from the same state:
    loss, grad_norm and every updated parameter within the train tests'
    float32 bar (rtol 1e-4 / atol 1e-6), but for the elements whose first
    update follows rounding noise: 0 < |g| below 1e-6 of the leaf's max
    or below 1e-6 (`test_torch_train.sign_noise`'s rule), where AdamW's
    m / sqrt(v) turns the gradient's last bits into the update's."""
    rc, tc = cfgs("float32")
    rparams, tparams = shared_train_params(rc)
    kw = dict(name="adamw", lr=1e-3, warmup_steps=2, total_steps=100)
    rtc = rloop.TrainConfig(optimizer=ROptimizerConfig(**kw), remat="none")
    ttc = TrainConfig(optimizer=OptimizerConfig(**kw), remat="none")
    rapi, tapi = rreg.get_model(rc), treg.get_model(tc)
    from repro.optim import make_optimizer as r_make_optimizer
    from repro_torch.optim import make_optimizer
    rstate = r_make_optimizer(rtc.optimizer)[0](rparams)
    tstate = make_optimizer(ttc.optimizer)[0](tparams)
    rb, tb = _train_batch(tc, 10)
    noise = [(g != 0) & (g.abs() < max(1e-6 * float(g.abs().max()), 1e-6))
             for g in leaves(loss_and_grads(tapi, "none")(tparams, tb)[1])]
    rparams, rstate, rm = jax.jit(rloop.make_train_step(rapi, rtc))(
        rparams, rstate, rb)
    tparams, tstate, tm = make_train_step(tapi, ttc)(tparams, tstate, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-4)
    assert int(tstate.step) == int(rstate.step) == 1
    for g, w, skip in zip(leaves(tparams), jax.tree.leaves(rparams), noise):
        keep = ~skip.numpy()
        np.testing.assert_allclose(f32(g)[keep], f32(w)[keep], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("use_kernels", ROUTES)
def test_decode_matches_forward(use_kernels):
    """Teacher-forced decode through the cache reproduces the forward's
    hidden states (the reference's `test_whisper_decode_matches_forward`
    and its tolerance, rtol = atol = 0.08), on the port's own seeded
    parameters."""
    cfg = CONFIGS[ARCH].reduced()
    api = treg.get_model(cfg)
    p = api.init(torch.Generator().manual_seed(0), "cpu")
    _, tf = frames(cfg, 2, 24, seed=1)
    _, toks = tokens(cfg, 2, 10, seed=2)
    enc = twh.encode(p, cfg, tf, remat="none", use_kernels=use_kernels)
    x, _ = twh.decode(p, cfg, toks, enc, remat="none",
                      use_kernels=use_kernels)
    full = x @ p["tok_embed"].T
    logits, cache = api.prefill(p, {"frames": tf, "tokens": toks[:, :4]}, 16,
                                use_kernels=use_kernels)
    got = [logits[:, -1]]
    for t in range(4, 10):
        step, cache = api.decode_step(p, cache, toks[:, t:t + 1],
                                      use_kernels=use_kernels)
        got.append(step[:, 0])
    np.testing.assert_allclose(f32(torch.stack(got, dim=1)), f32(full[:, 3:]),
                               rtol=0.08, atol=0.08)


# ---------------------------------------------------------------------------
# the kernel routes
# ---------------------------------------------------------------------------

def test_flash_block_is_128_or_the_largest_divisor_below():
    assert [tcommon.flash_block(n) for n in (1500, 228, 150, 4, 128, 512,
                                             1499)] \
        == [125, 114, 75, 4, 128, 128, 1]


@pytest.mark.parametrize("sq,skv,causal", [(1500, 1500, False),
                                           (228, 1500, False),
                                           (228, 228, True), (4, 150, False)])
def test_flash_divisor_blocks_equal_the_plain_attention(sq, skv, causal):
    """Where the masks make the function independent of the grid, the
    flash route on divisor blocks computes the plain attention (float32
    `TOL`); GQA 4 / 2, head dim 64 as Whisper's."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.normal(size=(1, sq, 4, 64)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, skv, 2, 64)).astype(
        np.float32)) for _ in range(2))
    want = tcommon._sdpa_chunked(q, k, v, causal=causal, window=None,
                                 q_offset=0)
    got = tcommon._flash(q, k, v, causal=causal, window=None)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["float32"])


@pytest.mark.parametrize("b,kvh", [(1, 4), (1, 2), (3, 2)])
def test_flash_route_hands_the_kernel_contiguous_heads(monkeypatch, b, kvh):
    """The CUDA kernel takes contiguous (bh, s, d) tensors only; the CPU
    runs the plain version, which does not care, so the route's layout
    is checked here through a stand-in: one sequence (where a transposed
    view reshapes without a copy) and GQA's broadcast included."""
    seen = []

    def kernel(q, k, v, **kw):
        seen.extend(t.is_contiguous() for t in (q, k, v))
        return flash_attention_plain(q, k, v, **kw)

    from repro_torch.kernels.flash_attention import flash_attention_plain
    monkeypatch.setattr(tcommon, "flash_attention", kernel)
    q = torch.randn((b, 12, 4, 32))
    k, v = torch.randn((b, 20, kvh, 32)), torch.randn((b, 20, kvh, 32))
    got = tcommon._flash(q, k, v, causal=False, window=None)
    want = tcommon._sdpa_chunked(q, k, v, causal=False, window=None,
                                 q_offset=0)
    assert seen == [True] * 3
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL["float32"])


def test_flash_with_a_window_keeps_the_reference_grid():
    """A window makes the function depend on the grid: a length over 128
    that 128 does not divide still raises."""
    q = torch.zeros((1, 228, 2, 32))
    with pytest.raises(ValueError, match="multiples of the blocks"):
        tcommon._flash(q, q, q, causal=True, window=64)
    with pytest.raises(ValueError, match="multiples of the blocks"):
        tcommon._flash(q, q[:, :150], q[:, :150], causal=False, window=64)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_cross_route_equals_the_plain_attention(dtype):
    """One query a sequence over 1,500 cross keys: the paged route reads
    them as 4-token blocks, every length 1,500, and computes the plain
    cross-attention (`TOL`)."""
    _, tc = cfgs(dtype)
    _, port = params(dtype)
    p = port["dec_layers"][0]["cross_attn"]
    gen = torch.Generator().manual_seed(12)
    dt = tcommon.dtype_of(tc)
    x = torch.randn((3, 1, tc.d_model), generator=gen).to(dt)
    kv_x = torch.randn((3, 1500, tc.d_model), generator=gen).to(dt)
    idx = tcommon.kv_index(3, 1500, "cpu")
    assert idx.block == 4 and idx.tables.shape == (3, 375)
    assert idx.lengths.tolist() == [1500] * 3
    pos = torch.zeros((3, 1), dtype=torch.long)
    got, _ = tcommon.apply_attention(p, tc, x, pos, kv_x=kv_x, causal=False,
                                     index=idx)
    want, _ = tcommon.apply_attention(p, tc, x, pos, kv_x=kv_x, causal=False,
                                      use_kernels=False)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def test_cross_attention_takes_no_cache():
    _, tc = cfgs("float32")
    p = params("float32")[1]["dec_layers"][0]["cross_attn"]
    x = torch.zeros((1, 1, tc.d_model))
    kv = {"k": torch.zeros((1, 8, 2, 32)), "v": torch.zeros((1, 8, 2, 32))}
    with pytest.raises(ValueError, match="takes no cache"):
        tcommon.apply_attention(p, tc, x, torch.zeros((1, 1)), kv_x=x,
                                cache=kv, cache_pos=torch.zeros(1))


# ---------------------------------------------------------------------------
# the decoder-only entry points refuse it
# ---------------------------------------------------------------------------

def test_decoder_only_entry_points_refuse_the_encoder_decoder():
    """`models.transformer`, `serve.Engine` and the serve launcher refuse
    the encoder-decoder, as the reference's launcher does; whisper's
    entry points refuse a decoder-only config."""
    cfg = CONFIGS[ARCH].reduced()
    for call in (lambda: ttr.init_params(None, cfg, "cpu"),
                 lambda: ttr.init_cache(cfg, 1, 8, "cpu")):
        with pytest.raises(NotImplementedError, match="models.whisper"):
            call()
    with pytest.raises(NotImplementedError, match="decoder-only archs"):
        make_engine(cfg, device="cpu")
    dense = CONFIGS["granite-8b"].reduced()
    with pytest.raises(NotImplementedError, match="decoder-only archs"):
        Engine(cfg, treg.get_model(dense).init(None, "cpu"), EngineConfig())
    with pytest.raises(SystemExit, match="decoder-only archs"):
        tlaunch.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    with pytest.raises(ValueError, match="not an encoder-decoder"):
        twh.init_params(None, dense, "cpu")
