"""Parity of the port's LM scaffold (`repro_torch.configs`, `models`)
with the reference's on the CPU.

Both packages get the same parameters and inputs (`_lm_parity.py`).
float32 configs hold within rtol 1e-4 / atol 1e-5, bfloat16 ones within
the reference's own cache-against-forward bar, rtol = atol = 0.08
(`tests/test_models.py`).  The kernel path
(`use_kernels=True`) runs the flash and paged kernels' plain versions
here; the plain path runs the transcribed `_sdpa_chunked`.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import TOL, configs, cut, f32, inputs, shared_params

from repro.configs import ARCH_IDS as R_ARCH_IDS, CONFIGS as R_CONFIGS
from repro.configs import SHAPES as R_SHAPES, applicable_shapes as r_shapes
from repro.models import common as rcommon, registry as rreg
from repro.models import transformer as rtr
from repro_torch.configs import (ARCH_IDS, CONFIGS, SHAPES,
                                 applicable_shapes, get_config)
from repro_torch.models import common as tcommon, registry as treg
from repro_torch.models import transformer as ttr

DENSE = ["granite-8b", "stablelm-1.6b", "starcoder2-15b", "qwen2-72b",
         "chameleon-34b"]
#: the MoE, hybrid and RWKV families have their parity cases in
#: `tests/test_torch_lm_{jamba,moe,rwkv}.py`, the encoder-decoder in
#: `tests/test_torch_whisper.py`
DTYPES = ["float32", "bfloat16"]


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(R_CONFIGS))
def test_configs_equal_the_reference(arch):
    cfg, ref = CONFIGS[arch], R_CONFIGS[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert cfg.param_count() == ref.param_count()
    assert cfg.reduced().param_count() == ref.reduced().param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert applicable_shapes(cfg) == r_shapes(ref)
    assert cfg.hd == ref.hd and get_config(arch) is cfg


def test_registry_tables_equal_the_reference():
    assert ARCH_IDS == R_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in R_SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-1b")


def test_granite_8b_published_size():
    cfg = CONFIGS["granite-8b"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab) == (36, 4096, 32, 8, 128, 14336, 49152)
    assert round(cfg.param_count() / 1e9, 3) == 8.254


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rope_pct", [1.0, 0.25, 0.0])
def test_rope_matches_the_reference(rope_pct, dtype):
    """Interleaved pairs (0::2 with 1::2), partial rotary, float32
    angles, per-slot position rows."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 900, (2, 5)).astype(np.int32)
    rdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = rcommon.apply_rope(jnp.asarray(x, rdt), jnp.asarray(pos), 10000.0,
                              rope_pct)
    got = tcommon.apply_rope(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(pos), 10000.0, rope_pct)
    assert got.dtype == tdt
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
    if rope_pct == 0.25:          # the unrotated lanes pass through
        assert torch.equal(got[..., 8:],
                           torch.from_numpy(x).to(tdt)[..., 8:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_norms_match_the_reference(norm, dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=64).astype(np.float32)}
    if norm == "ln":
        p["bias"] = rng.normal(size=64).astype(np.float32)
    rdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = rcommon.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x, rdt))
    got = tcommon.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x).to(tdt))
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("case", [
    dict(causal=True, window=None, q_offset=0, sq=16, skv=16, chunk=4),
    dict(causal=True, window=5, q_offset=0, sq=16, skv=16, chunk=None),
    dict(causal=False, window=None, q_offset=0, sq=8, skv=12, chunk=None),
    dict(causal=True, window=None, q_offset=[3, 9], sq=1, skv=16,
         chunk=None),
    dict(causal=True, window=4, q_offset=[0, 6], sq=6, skv=16, chunk=3),
    dict(causal=True, window=None, q_offset=[20, 40], sq=1, skv=16,
         chunk=None),
])
def test_plain_attention_matches_the_reference(case):
    """`_sdpa_chunked` transcribed: chunks, masks, GQA grouping and
    per-slot query offsets (past the cache included)."""
    rng = np.random.default_rng(5)
    b, h, kvh, hd = 2, 4, 2, 16
    q = rng.normal(size=(b, case["sq"], h, hd)).astype(np.float32)
    k = rng.normal(size=(b, case["skv"], kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, case["skv"], kvh, hd)).astype(np.float32)
    off = case["q_offset"]
    kw = dict(causal=case["causal"], window=case["window"],
              chunk=case["chunk"])
    want = rcommon._sdpa_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_offset=off if isinstance(off, int) else jnp.asarray(off), **kw)
    got = tcommon._sdpa_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=off if isinstance(off, int) else torch.tensor(off), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["granite-8b", "chameleon-34b"])
def test_random_train_batch_is_the_reference_batch(arch):
    rc, tc = configs(arch)
    want = rreg.random_train_batch(rc, 2, 8, seed=3)
    got = treg.random_train_batch(tc, 2, 8, seed=3, device="cpu")
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.array_equal(f32(got[name]), f32(want[name]))


def test_convert_carries_bf16_bytes_and_layer_order():
    rc, tc = configs("granite-8b")
    ref, port = shared_params(rc, tc)
    _, period, n_super = rtr.split_layout(rc)
    assert len(port["layers"]) == n_super * period == tc.n_layers
    for u in range(n_super):
        want = np.asarray(ref["stacks"][0]["attn"]["wq"][u])
        got = port["layers"][u]["attn"]["wq"]
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))
    assert torch.equal(port["head"].float(), torch.from_numpy(
        np.asarray(ref["head"].astype(jnp.float32))))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def params(arch, dtype):
    """`shared_params` of the reduced config, made once a module."""
    return shared_params(*configs(arch, dtype))


@functools.lru_cache(maxsize=None)
def reference_forward(arch, dtype):
    rc, tc = configs(arch, dtype)
    ref, _ = params(arch, dtype)
    rin, _ = inputs(tc, 2, 16)
    x, _, _ = rtr.forward(ref, rc, remat="none", **rin)
    return f32(x @ rtr.head_matrix(ref, rc))


_LOSSES = {}


def reference_loss(arch, dtype, batch):
    if (arch, dtype) not in _LOSSES:
        rc, _ = configs(arch, dtype)
        _LOSSES[arch, dtype] = float(rtr.loss_fn(params(arch, dtype)[0], rc,
                                                 batch, remat="none"))
    return _LOSSES[arch, dtype]


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_the_reference(arch, dtype, use_kernels):
    want = reference_forward(arch, dtype)
    _, tc = configs(arch, dtype)
    _, port = params(arch, dtype)
    _, tin = inputs(tc, 2, 16)
    y, _, aux = ttr.forward(port, tc, use_kernels=use_kernels, **tin)
    got = y @ ttr.head_matrix(port, tc)
    assert got.dtype == tcommon.dtype_of(tc) and float(aux) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def decode_steps(tc, tin):
    """The six teacher-forced decode tokens after a 6-token prompt, as
    (reference, port) arrays: the batch's own tokens, or seeded ones
    after a prompt of embeds."""
    if "embeds" in tin:
        toks = np.random.default_rng(6).integers(0, tc.vocab, (2, 6))
        return jnp.asarray(toks, jnp.int32), torch.from_numpy(
            toks.astype(np.int32))
    return jnp.asarray(tin["tokens"][:, 6:].numpy()), tin["tokens"][:, 6:]


@functools.lru_cache(maxsize=None)
def reference_decode(arch, dtype):
    """The reference's prefill and decode logits (float32 numpy), final
    positions and last layer's K cache: run once for both routes."""
    rc, tc = configs(arch, dtype)
    ref, _ = params(arch, dtype)
    rin, tin = inputs(tc, 2, 12)
    rsteps, _ = decode_steps(tc, tin)
    logits, cache = rtr.prefill(ref, rc, cut(rin, 0, 6), 16)
    out = [f32(logits)]
    for t in range(6):
        logits, cache = rtr.decode_step(ref, rc, cache, rsteps[:, t:t + 1])
        out.append(f32(logits))
    return out, np.asarray(cache["pos"]).tolist(), \
        f32(cache["stacks"][0]["kv"]["k"][-1])


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference(arch, dtype, use_kernels):
    """Prefill 6 tokens into a 16-token cache, then 6 teacher-forced
    decode steps: every step's logits, the final positions and K cache."""
    want, want_pos, want_k = reference_decode(arch, dtype)
    _, tc = configs(arch, dtype)
    _, port = params(arch, dtype)
    _, tin = inputs(tc, 2, 12)
    _, tsteps = decode_steps(tc, tin)
    logits, cache = ttr.prefill(port, tc, cut(tin, 0, 6), 16,
                                use_kernels=use_kernels)
    got = [f32(logits)]
    for t in range(6):
        logits, cache = ttr.decode_step(port, tc, cache, tsteps[:, t:t + 1],
                                        use_kernels=use_kernels)
        got.append(f32(logits))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL[dtype])
    assert cache["pos"].tolist() == want_pos
    np.testing.assert_allclose(f32(cache["layers"][-1]["kv"]["k"]), want_k,
                               **TOL[dtype])


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_matches_the_reference(arch, dtype, use_kernels):
    rc, tc = configs(arch, dtype)
    ref, port = params(arch, dtype)
    rin, tin = inputs(tc, 2, 16)
    labels = np.random.default_rng(7).integers(-1, tc.vocab, (2, 16))
    rin["labels"] = jnp.asarray(labels, jnp.int32)
    tin["labels"] = torch.from_numpy(labels.astype(np.int32))
    want = reference_loss(arch, dtype, rin)
    got = ttr.loss_fn(port, tc, tin, use_kernels=use_kernels)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, **TOL[dtype])


# ---------------------------------------------------------------------------
# mirrors of the reference's model tests, on the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("arch", ["granite-8b", "stablelm-1.6b",
                                  "starcoder2-15b", "qwen2-72b"])
def test_decode_matches_forward(arch, use_kernels):
    """Teacher-forced decode through the cache reproduces the full
    forward's logits (`tests/test_models.py`'s check, its tolerance)."""
    cfg = CONFIGS[arch].reduced()
    api = treg.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    x, _, _ = ttr.forward(params, cfg, tokens=toks, use_kernels=use_kernels)
    full = x @ ttr.head_matrix(params, cfg)
    logits, cache = api.prefill(params, {"tokens": toks[:, :6]}, 16,
                                use_kernels=use_kernels)
    got = [logits[:, -1]]
    for t in range(6, 12):
        step, cache = api.decode_step(params, cache, toks[:, t:t + 1],
                                      use_kernels=use_kernels)
        got.append(step[:, 0])
    np.testing.assert_allclose(f32(torch.stack(got, dim=1)),
                               f32(full[:, 5:12]), rtol=0.08, atol=0.08)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_per_slot_positions_mixed_depth(use_kernels):
    """Two slots at different cache depths each attend to their own
    prefix only."""
    cfg = CONFIGS["stablelm-1.6b"].reduced()
    api = treg.get_model(cfg)
    params = api.init(torch.Generator().manual_seed(4), "cpu")
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 9)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 5)).astype(np.int32))
    kw = dict(use_kernels=use_kernels)

    cache = ttr.init_cache(cfg, 2, 16, "cpu")
    _, ca, _ = ttr.forward(params, cfg, tokens=a[:, :8],
                           cache=ttr.slice_cache(cache, 0), **kw)
    cache = ttr.merge_cache(cache, ca, 0)
    _, cb, _ = ttr.forward(params, cfg, tokens=b[:, :4],
                           cache=ttr.slice_cache(cache, 1), **kw)
    cache = ttr.merge_cache(cache, cb, 1)
    assert cache["pos"].tolist() == [8, 4]
    logits, _ = api.decode_step(params, cache,
                                torch.cat([a[:, 8:9], b[:, 4:5]]), **kw)

    _, cache_a = api.prefill(params, {"tokens": a[:, :8]}, 16, **kw)
    ref_a, _ = api.decode_step(params, cache_a, a[:, 8:9], **kw)
    _, cache_b = api.prefill(params, {"tokens": b[:, :4]}, 16, **kw)
    ref_b, _ = api.decode_step(params, cache_b, b[:, 4:5], **kw)
    np.testing.assert_allclose(f32(logits[0]), f32(ref_a[0]), rtol=0.08,
                               atol=0.08)
    np.testing.assert_allclose(f32(logits[1]), f32(ref_b[0]), rtol=0.08,
                               atol=0.08)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_idle_slot_past_the_cache_end_matches_the_reference(use_kernels):
    """A slot whose pos has passed S_max writes nothing and attends to
    the whole cache, as the reference's one-hot write and mask do; the
    other slot decodes as usual."""
    rc, tc = configs("granite-8b", "float32")
    ref, port = shared_params(rc, tc)
    rin, tin = inputs(tc, 2, 8)
    _, rcache = rtr.prefill(ref, rc, rin, 16)
    _, tcache = ttr.prefill(port, tc, tin, 16, use_kernels=use_kernels)
    pos = np.array([8, 19], np.int32)
    rcache["pos"] = jnp.asarray(pos)
    tcache["pos"] = torch.from_numpy(pos)
    before = tcache["layers"][0]["kv"]["k"][1].clone()
    step = np.array([[3], [7]], np.int32)
    for _ in range(3):
        rl, rcache = rtr.decode_step(ref, rc, rcache, jnp.asarray(step))
        tl, tcache = ttr.decode_step(port, tc, tcache,
                                     torch.from_numpy(step),
                                     use_kernels=use_kernels)
        np.testing.assert_allclose(f32(tl), f32(rl), **TOL["float32"])
    assert tcache["pos"].tolist() == [11, 22]
    assert torch.equal(tcache["layers"][0]["kv"]["k"][1], before)
    np.testing.assert_allclose(
        f32(tcache["layers"][0]["kv"]["k"]),
        f32(rcache["stacks"][0]["kv"]["k"][0]), **TOL["float32"])


def test_kernel_path_refuses_a_prompt_at_a_nonzero_offset():
    """The flash kernel attends a prompt from position 0 only: a
    multi-token call deeper in the cache raises on the kernel path and
    runs on the plain one, as the reference computes it."""
    rc, tc = configs("granite-8b", "float32")
    ref, port = shared_params(rc, tc)
    rin, tin = inputs(tc, 1, 8)
    _, rcache = rtr.prefill(ref, rc, cut(rin, 0, 4), 16)
    _, tcache = ttr.prefill(port, tc, cut(tin, 0, 4), 16)
    with pytest.raises(ValueError, match="nonzero offset"):
        ttr.forward(port, tc, tokens=tin["tokens"][:, 4:], cache=tcache)
    x, rnew, _ = rtr.forward(ref, rc, tokens=rin["tokens"][:, 4:],
                             cache=rcache, remat="none")
    y, tnew, _ = ttr.forward(port, tc, tokens=tin["tokens"][:, 4:],
                             cache=tcache, use_kernels=False)
    np.testing.assert_allclose(f32(y), f32(x), **TOL["float32"])
    assert tnew["pos"].tolist() == [8]


def test_kernel_path_decode_refuses_a_window():
    """The paged kernel has no window mask: a windowed config decodes on
    the plain path only, and there matches the reference."""
    rc, tc = configs("granite-8b", "float32")
    rc = dataclasses.replace(rc, attn_window=4)
    tc = dataclasses.replace(tc, attn_window=4)
    ref, port = shared_params(rc, tc)
    rin, tin = inputs(tc, 1, 9)
    rl, rcache = rtr.prefill(ref, rc, cut(rin, 0, 8), 16)
    tl, tcache = ttr.prefill(port, tc, cut(tin, 0, 8), 16)
    np.testing.assert_allclose(f32(tl), f32(rl), **TOL["float32"])
    with pytest.raises(ValueError, match="no window mask"):
        ttr.decode_step(port, tc, tcache, tin["tokens"][:, 8:])
    rl, _ = rtr.decode_step(ref, rc, rcache, rin["tokens"][:, 8:])
    tl, _ = ttr.decode_step(port, tc, tcache, tin["tokens"][:, 8:],
                            use_kernels=False)
    np.testing.assert_allclose(f32(tl), f32(rl), **TOL["float32"])
