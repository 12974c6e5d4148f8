"""Parity of the port's MoE layer (`repro_torch.models.moe`) with the
reference's on the CPU.

Routing decisions (top-k experts, the stable sort, capacity drops and
slots) must be equal exactly when both packages get the same float32
router logits: the tests feed one-hot tokens through a router whose
rows are the logits, so x @ router is exact in both.  Outputs and aux
losses in float32 hold within rtol 1e-5; the MoE configs' own layers
(reduced Jamba, Arctic, Kimi) within `TOL` in both dtypes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import TOL, configs, f32, shared_params

from repro.models import moe as rmoe
from repro.models import transformer as rtr
from repro_torch.models import moe as tmoe

MOE_ARCHS = ["jamba-v0.1-52b", "arctic-480b", "kimi-k2-1t-a32b"]
DTYPES = ["float32", "bfloat16"]
F32 = dict(rtol=1e-5, atol=1e-6)


def moe_config(n_experts, top_k, d=32, ff=16, shared=0):
    """A float32 MoE config of the reference's family at a given width."""
    _, tc = configs("kimi-k2-1t-a32b", "float32")
    moe = dataclasses.replace(tc.moe, n_experts=n_experts, top_k=top_k,
                              d_expert_ff=ff, n_shared_experts=shared)
    return dataclasses.replace(tc, d_model=d, moe=moe)


def reference_routing(logits, k, cap):
    """`repro/models/moe.py` lines 66-88 (`apply_moe`'s routing), run by
    JAX on the given float32 logits."""
    t, e = logits.shape
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    top_w, top_e = jax.lax.top_k(probs, k)
    top_w = top_w / jnp.maximum(top_w.sum(-1, keepdims=True), 1e-9)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e)
    se_ = flat_e[order]
    pos_in_e = jnp.arange(t * k) - jnp.searchsorted(se_, se_, side="left")
    keep = pos_in_e < cap
    slot = jnp.where(keep, se_ * cap + pos_in_e, e * cap)
    st_ = jnp.repeat(jnp.arange(t), k)[order]
    return {n: np.asarray(v) for n, v in dict(
        top_e=top_e, order=order, keep=keep, slot=slot, st=st_,
        top_w=top_w, sw=top_w.reshape(-1)[order]).items()}


def logit_cases():
    rng = np.random.default_rng(11)
    ties = rng.integers(0, 3, (24, 6)).astype(np.float32)    # many ties
    flat = np.zeros((8, 16), np.float32)                      # all tied
    return {
        "random": (rng.normal(size=(24, 4)).astype(np.float32), 2, None),
        "ties": (ties, 2, None),
        "all tied, cap 1": (flat, 2, 1),
        "decode 8 slots, E 16": (rng.normal(size=(8, 16)).astype(
            np.float32) * 3, 2, None),
        "top-8 of 64": (rng.normal(size=(40, 64)).astype(np.float32), 8,
                        None),
    }


@pytest.mark.parametrize("case", sorted(logit_cases()))
def test_routing_equals_the_reference(case):
    """top_e, the sort order, keep, slots and tokens exactly; weights
    within float32 rounding."""
    logits, k, cap = logit_cases()[case]
    t, e = logits.shape
    cfg = moe_config(e, k)
    cap = tmoe.capacity_for(cfg, t, cap)
    if case.startswith("decode"):
        assert cap == 1       # ceil(16/16)·1.25 -> 1: a second token drops
    want = reference_routing(logits, k, cap)
    r = tmoe.route(torch.softmax(torch.from_numpy(logits), -1), k, cap)
    for name in ("top_e", "order", "keep", "slot", "st"):
        assert np.array_equal(getattr(r, name).numpy(), want[name]), name
    for name in ("top_w", "sw"):
        np.testing.assert_allclose(getattr(r, name).numpy(), want[name],
                                   rtol=1e-6)
    assert (~r.keep).any() == (~want["keep"]).any()


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("case", sorted(logit_cases()))
def test_apply_moe_with_given_logits_equals_the_reference(case, shared):
    """One-hot tokens through a router made of the logits: the whole
    layer (dispatch, expert GEMMs, drops, the combine, shared experts)
    and both aux losses within rtol 1e-5 in float32."""
    logits, k, cap = logit_cases()[case]
    t, e = logits.shape
    d = max(32, t)
    cfg = moe_config(e, k, d=d, shared=shared)
    rng = np.random.default_rng(12)
    x = np.eye(t, d, dtype=np.float32)[None]                   # (1, T, d)
    router = np.zeros((d, e), np.float32)
    router[:t] = logits
    p = {"router": router}
    for name, shape in (("w_gate", (e, d, 16)), ("w_up", (e, d, 16)),
                        ("w_down", (e, 16, d))):
        p[name] = rng.normal(size=shape).astype(np.float32)
    if shared:
        for name, shape in (("shared_gate", (1, d, 16)),
                            ("shared_up", (1, d, 16)),
                            ("shared_down", (1, 16, d))):
            p[name] = rng.normal(size=shape).astype(np.float32)
    want, waux = rmoe.apply_moe({n: jnp.asarray(v) for n, v in p.items()},
                                cfg, jnp.asarray(x), capacity=cap)
    got, aux = tmoe.apply_moe({n: torch.from_numpy(v) for n, v in p.items()},
                              cfg, torch.from_numpy(x), capacity=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert sorted(aux) == sorted(waux)
    for name in aux:
        np.testing.assert_allclose(float(aux[name]), float(waux[name]),
                                   rtol=1e-5)


def _moe_layer(arch, dtype):
    """The first MoE layer's parameters of a reduced config, in both
    packages."""
    rc, tc = configs(arch, dtype)
    ref, port = shared_params(rc, tc)
    layout = rtr.layer_layout(rc)
    i = next(i for i, (_, moe) in enumerate(layout) if moe)
    prefix, period, _ = rtr.split_layout(rc)
    rblock = (ref["prefix"][i] if i < prefix else
              jax.tree.map(lambda a: a[(i - prefix) // period],
                           ref["stacks"][(i - prefix) % period]))
    return rc, tc, rblock["moe"], port["layers"][i]["moe"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_moe_layer_matches_the_reference(arch, dtype):
    """A reduced config's MoE layer on seeded activations: output and
    aux losses within `TOL` (float32: rtol 1e-5 for the aux losses)."""
    rc, tc, rp, tp = _moe_layer(arch, dtype)
    x = np.random.default_rng(13).normal(size=(2, 12, tc.d_model))
    rdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want, waux = rmoe.apply_moe(rp, rc, jnp.asarray(x, rdt))
    got, aux = tmoe.apply_moe(tp, tc, torch.from_numpy(x).to(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32))
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])
    tol = dict(rtol=1e-5) if dtype == "float32" else TOL[dtype]
    for name in waux:
        np.testing.assert_allclose(float(aux[name]), float(waux[name]),
                                   **tol)


def test_capacity_one_drops_the_second_token_of_an_expert():
    """The decode case: 8 slots, k = 2, E = 16 gives cap 1; of the
    tokens routed to one expert the first keeps it and the others drop
    to the overflow slot, as in the reference."""
    cfg = moe_config(16, 2, d=32)
    t, e = 8, 16
    logits = np.full((t, e), -5.0, np.float32)
    logits[:, 3] = 4.0                      # every token's first choice
    for i in range(t):
        logits[i, 4 + i] = 3.0              # distinct second choices
    assert tmoe.capacity_for(cfg, t) == 1
    r = tmoe.route(torch.softmax(torch.from_numpy(logits), -1), 2, 1)
    dropped = r.st[~r.keep].tolist()
    assert dropped == list(range(1, t))     # token 0 keeps expert 3
    assert r.slot[~r.keep].tolist() == [e] * (t - 1)
    want = reference_routing(logits, 2, 1)
    assert np.array_equal(r.keep.numpy(), want["keep"])


def test_combine_is_a_fixed_order_sum():
    """The combine visits each token's slots in ascending expert order
    (the reference's scatter-add order) and adds in x's dtype without
    atomics: two bfloat16 calls are bit-equal."""
    _, tc, _, tp = _moe_layer("jamba-v0.1-52b", "bfloat16")
    x = torch.from_numpy(np.random.default_rng(14).normal(
        size=(3, 5, tc.d_model))).to(torch.bfloat16)
    y1, _ = tmoe.apply_moe(tp, tc, x)
    y2, _ = tmoe.apply_moe(tp, tc, x)
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))
    # recompute token by token from the routing and the expert outputs
    xt = x.reshape(-1, tc.d_model)
    logits = xt.float() @ tp["router"]
    r = tmoe.route(torch.softmax(logits, -1), tc.moe.top_k,
                   tmoe.capacity_for(tc, xt.shape[0]))
    order = tmoe.combine_order(r, xt.shape[0])
    assert torch.equal(r.se[order], r.top_e.sort(dim=1).values)


def test_auto_routes_to_apply_moe_and_mesh_paths_wait():
    """Without a mesh apply_moe_auto is apply_moe, and the mesh paths
    (held against the reference in tests/test_torch_mesh_moe.py) wait
    for one: they refuse to run."""
    _, tc, _, tp = _moe_layer("arctic-480b", "float32")
    x = torch.from_numpy(np.random.default_rng(15).normal(
        size=(1, 6, tc.d_model)).astype(np.float32))
    a, aux_a = tmoe.apply_moe_auto(tp, tc, x)
    b, aux_b = tmoe.apply_moe(tp, tc, x)
    assert torch.equal(a, b) and aux_a.keys() == aux_b.keys()
    for fn in (tmoe.apply_moe_sharded, tmoe.apply_moe_a2a,
               tmoe.apply_moe_decode):
        with pytest.raises(RuntimeError, match="no mesh is active"):
            fn(tp, tc, x)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_shapes_equal_the_reference(arch):
    rc, tc = configs(arch)
    want = rmoe.init_moe(jax.random.PRNGKey(0), rc)
    got = tmoe.init_moe(torch.Generator().manual_seed(0), tc, "cpu")
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype).split(".")[-1] == str(want[name].dtype)


@pytest.mark.parametrize("sort", ["random", "ties"])
def test_dispatch_structure_demo_equals_the_reference(sort):
    """The (T, E) assignment CSR before the sort and the blocked one
    after: indptr, indices and values equal."""
    rng = np.random.default_rng(16)
    top_e = (rng.integers(0, 8, (40, 2)) if sort == "random"
             else np.tile(np.arange(2), (40, 1)))
    want = rmoe.dispatch_structure_demo(jnp.asarray(top_e), 8)
    got = tmoe.dispatch_structure_demo(torch.from_numpy(top_e), 8,
                                       device="cpu")
    for w, g in zip(want, got):
        assert (g.n_rows, g.n_cols) == (w.n_rows, w.n_cols)
        for name in ("indptr", "indices", "data"):
            assert np.array_equal(np.asarray(getattr(g, name).cpu()),
                                  np.asarray(getattr(w, name))), name
