"""Parity of the port's recurrent blocks (`repro_torch.models.mamba`,
`models.rwkv6`) with the reference's on the CPU, in float32 within
`TOL["float32"]` (rtol 1e-4, atol 1e-5).

Mamba: the causal conv, the SSM parameters, the chunked scan (one
chunk, several, and a length that is no multiple of the chunk), decode
steps from a state and a multi-token call with a state.  RWKV-6: token
shift, group norm, one factored sub-chunk, time mix on both branches
(the chunked one at multiples of 256, the per-token one otherwise, and
the per-token one at 256 with `rwkv_chunked_scan` off), channel mix,
decode from a state.  The reduced configs' own parameters come from
`_lm_parity.shared_params`.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import TOL, configs, shared_params

from repro.models import mamba as rmamba, rwkv6 as rrwkv
from repro.models import transformer as rtr, tuning as rtuning
from repro_torch.models import mamba as tmamba, rwkv6 as trwkv
from repro_torch.models import tuning as ttuning

F32 = TOL["float32"]


@pytest.fixture(autouse=True)
def _restore_knobs():
    r, t = rtuning.snapshot(), ttuning.snapshot()
    yield
    for name, v in r.items():
        rtuning.set_knob(name, v)
    for name, v in t.items():
        ttuning.set_knob(name, v)


@functools.lru_cache(maxsize=None)
def block(arch, kind, dtype="float32"):
    """(cfg ref, cfg port, reference params, port params) of the first
    `kind` block of a reduced config."""
    rc, tc = configs(arch, dtype)
    ref, port = shared_params(rc, tc)
    layout = rtr.layer_layout(rc)
    i = next(i for i, (k, _) in enumerate(layout) if k == kind)
    prefix, period, _ = rtr.split_layout(rc)
    rblock = (ref["prefix"][i] if i < prefix else
              jax.tree.map(lambda a: a[(i - prefix) // period],
                           ref["stacks"][(i - prefix) % period]))
    return rc, tc, rblock, port["layers"][i]


def acts(tc, b, s, seed):
    x = np.random.default_rng(seed).normal(size=(b, s, tc.d_model))
    return jnp.asarray(x, jnp.float32), torch.from_numpy(x.astype(np.float32))


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)


def close_tree(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        if isinstance(want[name], dict):
            close_tree(got[name], want[name])
        else:
            close(got[name], want[name])


# ---------------------------------------------------------------------------
# Mamba
# ---------------------------------------------------------------------------

def test_mamba_pieces_match_the_reference():
    """`_causal_conv` (with and without a conv state) and `_ssm_params`."""
    rc, tc, rp, tp = block("jamba-v0.1-52b", "mamba")
    rm, tm = rp["mamba"], tp["mamba"]
    di = tc.ssm.expand * tc.d_model
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, di)).astype(np.float32)
    st = rng.normal(size=(2, tc.ssm.d_conv - 1, di)).astype(np.float32)
    for state in (None, st):
        want, wst = rmamba._causal_conv(
            rm, jnp.asarray(x), None if state is None else jnp.asarray(state))
        got, gst = tmamba._causal_conv(
            tm, torch.from_numpy(x),
            None if state is None else torch.from_numpy(state))
        close(got, want)
        close(gst, wst)
    for g, w in zip(tmamba._ssm_params(tm, tc, torch.from_numpy(x)),
                    rmamba._ssm_params(rm, rc, jnp.asarray(x))):
        close(g, w)


@pytest.mark.parametrize("s_len", [1, 7, 128, 130, 384])
def test_mamba_sequence_matches_the_reference(s_len):
    """The chunked scan: one chunk (7, 128), a length no multiple of 128
    (one chunk of 130) and three chunks (384)."""
    rc, tc, rp, tp = block("jamba-v0.1-52b", "mamba")
    rx, tx = acts(tc, 2, s_len, seed=s_len)
    want, _ = rmamba.apply_mamba(rp["mamba"], rc, rx)
    got, st = tmamba.apply_mamba(tp["mamba"], tc, tx)
    assert st is None
    close(got, want)


@pytest.mark.parametrize("s_len", [5, 256])
def test_mamba_prompt_then_decode_matches_the_reference(s_len):
    """A prompt into a zero state (its h and the conv window of its last
    inputs), then four one-token steps from the state."""
    rc, tc, rp, tp = block("jamba-v0.1-52b", "mamba")
    rst = rmamba.init_mamba_state(rc, 2)
    tst = tmamba.init_mamba_state(tc, 2, "cpu")
    close_tree(tst, rst)
    rx, tx = acts(tc, 2, s_len + 4, seed=7)
    want, rst = rmamba.apply_mamba(rp["mamba"], rc, rx[:, :s_len], rst)
    got, tst = tmamba.apply_mamba(tp["mamba"], tc, tx[:, :s_len], tst)
    close(got, want)
    close_tree(tst, rst)
    for t in range(s_len, s_len + 4):
        want, rst = rmamba.apply_mamba(rp["mamba"], rc, rx[:, t:t + 1], rst)
        got, tst = tmamba.apply_mamba(tp["mamba"], tc, tx[:, t:t + 1], tst)
        close(got, want)
        close_tree(tst, rst)


def test_mamba_multi_token_call_keeps_h_but_not_the_conv_window():
    """A second multi-token call from a state starts from its h and pads
    the conv with zeros, as the reference does."""
    rc, tc, rp, tp = block("jamba-v0.1-52b", "mamba")
    rx, tx = acts(tc, 1, 12, seed=8)
    _, rst = rmamba.apply_mamba(rp["mamba"], rc, rx[:, :6],
                                rmamba.init_mamba_state(rc, 1))
    _, tst = tmamba.apply_mamba(tp["mamba"], tc, tx[:, :6],
                                tmamba.init_mamba_state(tc, 1, "cpu"))
    want, rst = rmamba.apply_mamba(rp["mamba"], rc, rx[:, 6:], rst)
    got, tst = tmamba.apply_mamba(tp["mamba"], tc, tx[:, 6:], tst)
    close(got, want)
    close_tree(tst, rst)


def test_prefix_scan_is_the_sequential_recurrence():
    """The doubling scan equals h_t = a_t h_{t-1} + b_t step by step."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 37, 3, 4)))
    b = torch.from_numpy(rng.normal(size=(2, 37, 3, 4)))
    acc_a, acc_b = tmamba._prefix_scan(a, b)
    h = torch.zeros(2, 3, 4, dtype=torch.float64)
    pa = torch.ones_like(h)
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        pa = pa * a[:, t]
        torch.testing.assert_close(acc_b[:, t], h)
        torch.testing.assert_close(acc_a[:, t], pa)


@pytest.mark.parametrize("fused", [True, False])
def test_mamba_gradients_match_the_reference(fused):
    """The gradient of sum(y²) over a three-chunk sequence, with each
    chunk recomputed in the backward pass (`mamba_fused_params`) and
    without, against the reference's: within 1e-4 of each leaf's max."""
    rc, tc, rp, tp = block("jamba-v0.1-52b", "mamba")
    rtuning.set_knob("mamba_fused_params", fused)
    ttuning.set_knob("mamba_fused_params", fused)
    rx, tx = acts(tc, 1, 384, seed=10)

    def rloss(p):
        return jnp.sum(rmamba.apply_mamba(p, rc, rx)[0] ** 2)

    want = jax.grad(rloss)(rp["mamba"])
    live = {n: t.detach().clone().requires_grad_()
            for n, t in tp["mamba"].items()}
    y, _ = tmamba.apply_mamba(live, tc, tx)
    torch.sum(y ** 2).backward()
    for name, w in want.items():
        w = np.asarray(w)
        g = live[name].grad.numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

def test_rwkv_pieces_match_the_reference():
    """`_token_shift` (with and without `last`), `_group_norm` and one
    factored sub-chunk `_wkv_subchunk` (the `_LW_CLIP` floor engaged)."""
    rc, tc, rp, tp = block("rwkv6-3b", "rwkv")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, tc.d_model)).astype(np.float32)
    last = rng.normal(size=(2, tc.d_model)).astype(np.float32)
    for lst in (None, last):
        close(trwkv._token_shift(torch.from_numpy(x), None if lst is None
                                 else torch.from_numpy(lst)),
              rrwkv._token_shift(jnp.asarray(x), None if lst is None
                                 else jnp.asarray(lst)))
    h = tc.d_model // tc.hd
    close(trwkv._group_norm(tp["time"]["ln_x"], torch.from_numpy(x), h),
          rrwkv._group_norm(rp["time"]["ln_x"], jnp.asarray(x), h))
    b, c, hd = 2, trwkv._SUB, tc.hd
    r, k, v = (rng.normal(size=(b, c, h, hd)).astype(np.float32)
               for _ in range(3))
    lw = -np.exp(rng.normal(size=(b, c, h, hd)) * 0.5).astype(np.float32)
    assert (lw < trwkv._LW_CLIP).any()
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    u = np.asarray(rp["time"]["u"])
    want = rrwkv._wkv_subchunk(*(jnp.asarray(a) for a in
                                 (s0, r, k, v, lw, u)))
    got = trwkv._wkv_subchunk(*(torch.from_numpy(np.array(a)) for a in
                                (s0, r, k, v, lw, u)))
    close(got[0], want[0])
    close(got[1], want[1])
    assert trwkv._LW_CLIP == rrwkv._LW_CLIP and trwkv._SUB == rrwkv._SUB


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("s_len", [100, 256, 512])
def test_rwkv_time_mix_matches_the_reference(s_len, chunked):
    """Both branches: 256 and 512 take the chunked form with the knob on
    and the per-token one with it off; 100 is per-token either way."""
    rc, tc, rp, tp = block("rwkv6-3b", "rwkv")
    rtuning.set_knob("rwkv_chunked_scan", chunked)
    ttuning.set_knob("rwkv_chunked_scan", chunked)
    rx, tx = acts(tc, 2, s_len, seed=s_len)
    rst = rrwkv.init_rwkv_state(rc, 2)["time"]
    tst = trwkv.init_rwkv_state(tc, 2, "cpu")["time"]
    want, rst = rrwkv.apply_rwkv_time(rp["time"], rc, rx, rst)
    got, tst = trwkv.apply_rwkv_time(tp["time"], tc, tx, tst)
    close(got, want)
    close_tree(tst, rst)


def test_rwkv_decode_from_a_state_matches_the_reference():
    """A 256-token prompt (chunked) into a state, then four decode steps
    of the time and channel mixes from it."""
    rc, tc, rp, tp = block("rwkv6-3b", "rwkv")
    rx, tx = acts(tc, 2, 260, seed=11)
    rst, tst = rrwkv.init_rwkv_state(rc, 2), trwkv.init_rwkv_state(tc, 2,
                                                                   "cpu")
    close_tree(tst, rst)
    for lo, hi in ((0, 256), (256, 257), (257, 258), (258, 259),
                   (259, 260)):
        want, rt = rrwkv.apply_rwkv_time(rp["time"], rc, rx[:, lo:hi],
                                         rst["time"])
        got, tt = trwkv.apply_rwkv_time(tp["time"], tc, tx[:, lo:hi],
                                        tst["time"])
        close(got, want)
        wc, rch = rrwkv.apply_rwkv_channel(rp["channel"], rc, rx[:, lo:hi],
                                           rst["channel"])
        gc, tch = trwkv.apply_rwkv_channel(tp["channel"], tc, tx[:, lo:hi],
                                           tst["channel"])
        close(gc, wc)
        rst, tst = {"time": rt, "channel": rch}, {"time": tt, "channel": tch}
        close_tree(tst, rst)


def test_rwkv_channel_mix_without_a_state_matches_the_reference():
    rc, tc, rp, tp = block("rwkv6-3b", "rwkv")
    rx, tx = acts(tc, 2, 9, seed=12)
    want, wst = rrwkv.apply_rwkv_channel(rp["channel"], rc, rx)
    got, gst = trwkv.apply_rwkv_channel(tp["channel"], tc, tx)
    assert wst is None and gst is None
    close(got, want)


def test_rwkv_chunked_gradients_match_the_reference():
    """Through the recomputed super-chunks: the gradient of sum(y²) at
    512 tokens within 1e-4 of each leaf's max."""
    rc, tc, rp, tp = block("rwkv6-3b", "rwkv")
    rx, tx = acts(tc, 1, 512, seed=13)

    def rloss(p):
        return jnp.sum(rrwkv.apply_rwkv_time(p, rc, rx)[0] ** 2)

    want = jax.tree.leaves(jax.grad(rloss)(rp["time"]))
    live = {n: ({m: t.detach().clone().requires_grad_() for m, t in v.items()}
                if isinstance(v, dict) else v.detach().clone()
                .requires_grad_())
            for n, v in tp["time"].items()}
    y, _ = trwkv.apply_rwkv_time(live, tc, tx)
    torch.sum(y ** 2).backward()
    got = [live[n][m].grad if isinstance(live[n], dict) else live[n].grad
           for n in sorted(live)
           for m in (sorted(live[n]) if isinstance(live[n], dict) else [0])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
