"""Shared fixtures and tests of the LM families' parity files
(`tests/test_torch_lm_jamba.py`, `test_torch_lm_moe.py` -- Arctic and
Kimi K2 -- and `test_torch_lm_rwkv.py`): the port's MoE, Mamba-hybrid and
RWKV decoders against the reference's on the CPU, at reduced Jamba
(Mamba + attention + MoE, a period of 8), Arctic (MoE with a dense
residual), Kimi K2 (a dense prefix layer, a shared expert) and RWKV-6.

Both packages get the same parameters and inputs (`_lm_parity.py`).
Logits and losses hold within `TOL` in both dtypes; `loss_fn`'s float32
gradient within 1e-4 of each leaf's max; served greedy tokens equal the
reference engine's on float32 reduced Jamba and RWKV, a prompt that its
bucket pads included (ROADMAP C7: the pad tokens run through the
recurrent state and the MoE capacity in both packages).  The kernel
path (`use_kernels=True`) runs the flash and paged kernels' plain
versions here.

The tests below take their cases from the fixtures of the file that
imports them: `arch` (its families), `use_kernels` (its routes), `knob`
(its mesh-only knobs) and `dtype` (both, defined here).  Each family
file imports `_restore_knobs` and `dtype` with the tests it runs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import (TOL, configs, cut, f32, inputs, shared_params,
                        shared_train_params, train_batch)

from repro.launch import serve as rlaunch
from repro.models import registry as rreg, transformer as rtr
from repro.models import tuning as rtuning
from repro.serve import EngineConfig as REngineConfig, Request as RRequest
from repro.serve.engine import Engine as REngine
from repro_torch.configs import CONFIGS
from repro_torch.launch import serve as tlaunch
from repro_torch.models import convert, registry as treg
from repro_torch.models import transformer as ttr, tuning as ttuning
from repro_torch.serve import Engine, EngineConfig, Request
from repro_torch.train.loop import loss_and_grads
from repro_torch.tree import leaves

DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True)
def _restore_knobs():
    r, t = rtuning.snapshot(), ttuning.snapshot()
    yield
    for name, v in r.items():
        rtuning.set_knob(name, v)
    for name, v in t.items():
        ttuning.set_knob(name, v)


@pytest.fixture(params=DTYPES)
def dtype(request):
    return request.param


@functools.lru_cache(maxsize=None)
def params(arch, dtype):
    return shared_params(*configs(arch, dtype))


# ---------------------------------------------------------------------------
# layout, supported configs, parameters
# ---------------------------------------------------------------------------

def test_family_is_supported_with_the_reference_layout(arch):
    """`require_supported` passes; the plain list of layers holds the
    reference's [prefix] + n_super x [period] in order, each layer with
    the reference's block kind and leaves."""
    rc, tc = configs(arch)
    ttr.require_supported(tc)
    assert ttr.layer_layout(tc) == rtr.layer_layout(rc)
    assert ttr.split_layout(tc) == rtr.split_layout(rc)
    ref, port = params(arch, "bfloat16")
    prefix, period, n_super = rtr.split_layout(rc)
    assert len(port["layers"]) == tc.n_layers
    for i, layer in enumerate(port["layers"]):
        want = (ref["prefix"][i] if i < prefix else
                jax.tree.map(lambda a, u=(i - prefix) // period: a[u],
                             ref["stacks"][(i - prefix) % period]))
        got_leaves = leaves(layer)
        want_leaves = jax.tree.leaves(want)
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            assert np.array_equal(f32(g), f32(w))


def test_init_params_and_cache_have_the_reference_shapes(arch):
    rc, tc = configs(arch)
    want = rreg.get_model(rc).init(jax.random.PRNGKey(0))
    got = convert.params_to_reference(
        treg.get_model(tc).init(torch.Generator().manual_seed(0), "cpu"), tc)
    assert jax.tree.structure(want) == jax.tree.structure(
        jax.tree.map(lambda t: 0, got, is_leaf=lambda t: isinstance(
            t, torch.Tensor)))
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    rcache = rtr.init_cache(rc, 3, 16)
    tcache = ttr.init_cache(tc, 3, 16, "cpu")
    prefix, period, _ = rtr.split_layout(rc)
    for i, layer in enumerate(tcache["layers"]):
        want = (rcache["prefix"][i] if i < prefix else
                jax.tree.map(lambda a: a[0],
                             rcache["stacks"][(i - prefix) % period]))
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda t: 0, layer))
        for g, w in zip(leaves(layer), jax.tree.leaves(want)):
            assert tuple(g.shape) == w.shape


def test_convert_round_trip_is_the_reference_tree(arch):
    """params_to_reference(params_from_reference(tree)) is the tree, the
    (n_super, E, d, ff) expert stacks, router, A_log, D, u and ln_x
    included, bytes unchanged."""
    rc, tc = configs(arch)
    ref, port = params(arch, "bfloat16")
    back = convert.params_to_reference(port, tc)
    want = jax.tree.leaves(ref)
    got = leaves(back)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert np.array_equal(f32(g), f32(w))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_forward(arch, dtype):
    rc, tc = configs(arch, dtype)
    ref, _ = params(arch, dtype)
    rin, _ = inputs(tc, 2, 16)
    x, _, aux = rtr.forward(ref, rc, remat="none", **rin)
    return f32(x @ rtr.head_matrix(ref, rc)), float(aux)


def test_forward_logits_and_aux_match_the_reference(arch, dtype,
                                                    use_kernels):
    want, want_aux = reference_forward(arch, dtype)
    _, tc = configs(arch, dtype)
    _, port = params(arch, dtype)
    _, tin = inputs(tc, 2, 16)
    y, _, aux = ttr.forward(port, tc, use_kernels=use_kernels, **tin)
    got = y @ ttr.head_matrix(port, tc)
    np.testing.assert_allclose(f32(got), want, **TOL[dtype])
    np.testing.assert_allclose(float(aux), want_aux,
                               **(dict(rtol=1e-5) if dtype == "float32"
                                  else TOL[dtype]))
    assert (want_aux > 0) == (tc.moe is not None)


@functools.lru_cache(maxsize=None)
def reference_decode(arch, dtype):
    """Prefill 6 tokens into a 16-token cache, then 6 teacher-forced
    steps: every step's logits and the final per-layer caches."""
    rc, tc = configs(arch, dtype)
    ref, _ = params(arch, dtype)
    rin, _ = inputs(tc, 2, 12)
    logits, cache = rtr.prefill(ref, rc, cut(rin, 0, 6), 16)
    out = [f32(logits)]
    for t in range(6, 12):
        logits, cache = rtr.decode_step(ref, rc, cache,
                                        rin["tokens"][:, t:t + 1])
        out.append(f32(logits))
    prefix, period, n_super = rtr.split_layout(rc)
    layers = [cache["prefix"][i] for i in range(prefix)]
    for u in range(n_super):
        for pos in range(period):
            layers.append(jax.tree.map(lambda a: a[u], cache["stacks"][pos]))
    return out, np.asarray(cache["pos"]).tolist(), layers


def test_prefill_and_decode_match_the_reference(arch, dtype, use_kernels):
    """Every step's logits, the final positions and the caches (K and V,
    Mamba h and conv, RWKV S and lasts) within `TOL`: every layer's in
    float32; in bfloat16 the first layer's, whose input has not yet
    crossed a layer (deeper states carry bfloat16 rounding of the whole
    residual stream, the logits are held instead)."""
    want, want_pos, want_layers = reference_decode(arch, dtype)
    _, tc = configs(arch, dtype)
    _, port = params(arch, dtype)
    _, tin = inputs(tc, 2, 12)
    logits, cache = ttr.prefill(port, tc, cut(tin, 0, 6), 16,
                                use_kernels=use_kernels)
    got = [f32(logits)]
    for t in range(6, 12):
        logits, cache = ttr.decode_step(port, tc, cache,
                                        tin["tokens"][:, t:t + 1],
                                        use_kernels=use_kernels)
        got.append(f32(logits))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL[dtype])
    assert cache["pos"].tolist() == want_pos
    depth = len(want_layers) if dtype == "float32" else 1
    for layer, want_layer in zip(cache["layers"][:depth],
                                 want_layers[:depth]):
        assert sorted(layer) == sorted(want_layer)
        for g, w in zip(leaves(layer), jax.tree.leaves(want_layer)):
            np.testing.assert_allclose(f32(g), f32(w), **TOL[dtype])


def test_loss_fn_with_the_aux_loss_matches_the_reference(arch, dtype,
                                                         use_kernels):
    rc, tc = configs(arch, dtype)
    ref, port = params(arch, dtype)
    rin, tin = inputs(tc, 2, 16)
    labels = np.random.default_rng(7).integers(-1, tc.vocab, (2, 16))
    rin["labels"] = jnp.asarray(labels, jnp.int32)
    tin["labels"] = torch.from_numpy(labels.astype(np.int32))
    want = float(rtr.loss_fn(ref, rc, rin, remat="none"))
    got = ttr.loss_fn(port, tc, tin, use_kernels=use_kernels)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, **TOL[dtype])


def test_gradients_match_the_reference(arch):
    """float32: `loss_fn` (the aux loss included) and its gradient in the
    reference's stacked layout, every leaf within 1e-4 of its max |g|."""
    rc, tc = configs(arch, "float32")
    rparams, tparams = shared_train_params(rc)
    rb, tb = train_batch(tc.vocab, 2, 16, seed=3)
    rloss, rgrads = jax.value_and_grad(
        lambda p: rreg.get_model(rc).loss_fn(p, rb, remat="none"))(rparams)
    tloss, tgrads = loss_and_grads(treg.get_model(tc), "full")(tparams, tb)
    np.testing.assert_allclose(float(tloss), float(rloss), rtol=1e-5)
    want = jax.tree.leaves(rgrads)
    got = leaves(tgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        w = f32(w)
        assert np.abs(f32(g) - w).max() <= 1e-4 * np.abs(w).max()


def test_remat_modes_give_the_same_loss_and_grads(arch):
    """none / dots / full over Mamba, MoE and RWKV blocks: bit-equal
    loss and gradients (the recomputed routing makes the same
    decisions)."""
    _, tc = configs(arch, "float32")
    _, tparams = shared_train_params(configs(arch, "float32")[0])
    _, tb = train_batch(tc.vocab, 2, 16, seed=4)
    out = {mode: loss_and_grads(treg.get_model(tc), mode)(tparams, tb)
           for mode in ("none", "dots", "full")}
    for mode in ("dots", "full"):
        assert torch.equal(out[mode][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(
            leaves(out[mode][1]), leaves(out["none"][1])))


# ---------------------------------------------------------------------------
# served tokens against the reference engine
# ---------------------------------------------------------------------------

def trace_requests(Req, lengths, vocab, seed=9):
    rng = np.random.default_rng(seed)
    return [Req(req_id=i, prompt=rng.integers(1, vocab, plen).tolist(),
                max_new_tokens=max_new)
            for i, (plen, max_new) in enumerate(lengths)]


#: (arch, slots and context, requests): Jamba's 150-token prompt runs
#: two Mamba chunks in its 256 bucket; RWKV's 200-token one the chunked
#: wkv branch (bucket 256), the others the per-token one
SERVED = {
    "jamba-v0.1-52b": (dict(max_batch=3, max_context=256, block_size=8),
                       [(9, 5), (150, 4), (17, 6), (3, 4)]),
    "rwkv6-3b": (dict(max_batch=2, max_context=256, block_size=8),
                 [(9, 5), (200, 4), (31, 6), (5, 3)]),
}


@functools.lru_cache(maxsize=None)
def reference_served(arch):
    rc, tc = configs(arch, "float32")
    ref, _ = params(arch, "float32")
    kw, lengths = SERVED[arch]
    eng = REngine(rc, ref, REngineConfig(**kw))
    out = eng.run(trace_requests(RRequest, lengths, tc.vocab))
    return out, eng.sched.stats()


def test_served_tokens_equal_the_reference_engine(arch, use_kernels):
    """Greedy tokens and scheduler stats equal the reference engine's,
    prompts padded to their buckets (C7) included."""
    want, want_stats = reference_served(arch)
    _, tc = configs(arch, "float32")
    _, port = params(arch, "float32")
    kw, lengths = SERVED[arch]
    eng = Engine(tc, port, EngineConfig(**kw), use_kernels=use_kernels)
    got = eng.run(trace_requests(Request, lengths, tc.vocab))
    assert got == want
    assert eng.sched.stats() == want_stats
    assert {b for b, _ in eng.prefill_times} >= {16, 256}


def test_prefill_padding_reaches_the_state_as_in_the_reference(arch):
    """ROADMAP C7, reproduced: a 9-token prompt runs in its 16 bucket, so
    the slot's recurrent state has also consumed 7 pad tokens (id 0).
    The engine's state equals the reference engine's, and differs from
    a prefill of the 9 tokens alone."""
    rc, tc = configs(arch, "float32")
    ref, port = params(arch, "float32")
    prompt = np.random.default_rng(10).integers(1, tc.vocab, 9).tolist()
    kw = dict(max_batch=2, max_context=32, block_size=8)
    reng = REngine(rc, ref, REngineConfig(**kw))
    reng._pending_logits = {}
    reng._prefill_one(1, prompt)
    eng = Engine(tc, port, EngineConfig(**kw))
    eng.prefill_slot(1, prompt)
    assert eng.cache["pos"].tolist() == np.asarray(
        reng.cache["pos"]).tolist() == [0, 9]
    i = next(i for i, (k, _) in enumerate(ttr.layer_layout(tc))
             if k != "attn")
    prefix, period, _ = rtr.split_layout(rc)
    rlayer = jax.tree.map(lambda a: a[(i - prefix) // period][1:2],
                          reng.cache["stacks"][(i - prefix) % period])
    tlayer = ttr.slice_cache(eng.cache, 1)["layers"][i]
    for g, w in zip(leaves(tlayer), jax.tree.leaves(rlayer)):
        np.testing.assert_allclose(f32(g), f32(w), **TOL["float32"])
    alone_toks = torch.tensor([prompt], dtype=torch.int32)
    _, alone = ttr.prefill(port, tc, {"tokens": alone_toks}, 32)
    first = leaves(tlayer)[0]
    assert not torch.allclose(first, leaves(alone["layers"][i])[0],
                              rtol=1e-3, atol=1e-3)


#: the knobs that act only under a mesh, each with a reduced config and a
#: prompt length at which the reference reads it
MESH_ONLY = {
    "sequence_parallel": ("jamba-v0.1-52b", 64),
    "moe_combine_bf16": ("arctic-480b", 16),
    "moe_all_to_all": ("kimi-k2-1t-a32b", 16),
    "moe_decode_weight_stationary": ("jamba-v0.1-52b", 16),
    "rwkv_batch_shard": ("rwkv6-3b", 256),
}


def test_mesh_only_knob_changes_nothing_on_one_device(knob):
    """On one device (no mesh) the reference's logits are the same with
    the knob on and off, and so are the port's (its MoE knobs act only
    under a mesh, tests/test_torch_mesh_moe.py); the two agree within
    `TOL`."""
    arch, seq = MESH_ONLY[knob]
    rc, tc = configs(arch, "float32")
    ref, port = params(arch, "float32")
    rin, tin = inputs(tc, 2, seq)
    outs = {}
    for value in (True, False):
        rtuning.set_knob(knob, value)
        ttuning.set_knob(knob, value)
        x, _, _ = rtr.forward(ref, rc, remat="none", **rin)
        y, _, _ = ttr.forward(port, tc, **tin)
        outs[value] = (f32(x @ rtr.head_matrix(ref, rc)),
                       f32(y @ ttr.head_matrix(port, tc)))
    assert np.array_equal(outs[True][0], outs[False][0])
    assert np.array_equal(outs[True][1], outs[False][1])
    np.testing.assert_allclose(outs[True][1], outs[True][0],
                               **TOL["float32"])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_the_family_on_the_cpu(arch, capsys):
    """`--device cpu`: every request finishes with its budget and the
    scheduler's statistics equal the reference launcher's."""
    argv = ["--arch", arch, "--reduced", "--requests", "3", "--max-new",
            "5", "--max-batch", "2"]
    out, stats = tlaunch.main(argv + ["--device", "cpu"])
    _, rstats = rlaunch.main(argv)
    reqs = tlaunch.synthetic_requests(3, CONFIGS[arch].reduced().vocab, 5)
    assert {r.req_id: r.max_new_tokens for r in reqs} == \
        {rid: len(v) for rid, v in out.items()}
    assert stats == rstats
    assert "on cpu" in capsys.readouterr().out
