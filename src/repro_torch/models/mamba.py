"""Mamba (S6) block for the Jamba hybrid: the counterpart of
`repro.models.mamba`.

A prompt or a training sequence runs the chunked scan: a loop over
chunks of `SCAN_CHUNK` tokens carries the (B, d_inner, d_state) state,
and inside a chunk the recurrence h_t = dA_t·h_{t-1} + dBx_t is a
parallel prefix (log2(chunk) doubling steps, Hillis-Steele) over the
chunk's (B, chunk, d_inner, d_state) float32 tensors.  Those tensors
are built chunk by chunk, as the reference builds them, never for the
whole sequence: at Jamba's d_inner 8192 one of them is 67 MB a
128-token chunk of one sequence.  The reference's
`lax.associative_scan` combines in another order, so the two agree
within float32 rounding, not bit for bit.  Under autograd each chunk is
recomputed in the backward pass when `tuning.mamba_fused_params` is on
(the reference's `jax.checkpoint` of its chunk body).

A decode step (one token with a state) is the one-step update.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, SSMConfig
from . import tuning
from .common import dense_init, dtype_of

Params = Dict[str, Any]

SCAN_CHUNK = 128


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    dt = dtype_of(cfg)
    dt_rank = max(d // 16, 1)
    a = torch.arange(1, s.d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d, 2 * di, dt, device),
        "conv_w": (torch.randn((s.d_conv, di), generator=gen, device=device)
                   * 0.1).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": dense_init(gen, di, dt_rank + 2 * s.d_state, dt, device),
        "dt_proj": dense_init(gen, dt_rank, di, dt, device),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=device),
        "A_log": torch.log(a)[None, :].repeat(di, 1),      # (di, ds)
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, di, d, dt, device),
    }


def _causal_conv(p: Params, x: torch.Tensor, state=None):
    """Depthwise causal conv1d.  x: (B, S, di).  state: (B, d_conv-1, di)."""
    dconv = p["conv_w"].shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, dconv - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = 0
    for j in range(dconv):
        out = out + p["conv_w"][j] * xp[:, j: j + x.shape[1], :]
    new_state = xp[:, -(dconv - 1):, :] if dconv > 1 else None
    return F.silu(out + p["conv_b"]), new_state


def _ssm_params(p: Params, cfg: ModelConfig, xc: torch.Tensor):
    """xc: (B, L, di) -> (dA (B,L,di,ds), dBx (B,L,di,ds), C (B,L,ds))."""
    s = cfg.ssm
    dt_rank = p["dt_proj"].shape[0]
    proj = xc @ p["x_proj"]
    dt_in, b_mat, c_mat = torch.split(proj, [dt_rank, s.d_state, s.d_state],
                                      dim=-1)
    pre = (dt_in @ p["dt_proj"]).float() + p["dt_bias"]
    delta = torch.logaddexp(pre, torch.zeros_like(pre))    # softplus
    a = -torch.exp(p["A_log"])                              # (di, ds)
    d_a = torch.exp(delta[..., None] * a)                   # (B, L, di, ds)
    d_bx = (delta * xc.float())[..., None] \
        * b_mat.float()[..., None, :]                       # (B, L, di, ds)
    return d_a, d_bx, c_mat.float()


def _prefix_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the affine maps h -> a·h + b
    (composition (a1, b1) then (a2, b2) = (a1·a2, a2·b1 + b2)), by
    doubling: log2(L) steps."""
    n = a.shape[1]
    shift = 1
    while shift < n:
        a_prev, b_prev = a[:, :-shift], b[:, :-shift]
        b = torch.cat([b[:, :shift], a[:, shift:] * b_prev + b[:, shift:]],
                      dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a_prev], dim=1)
        shift *= 2
    return a, b


def _chunk_body(p: Params, cfg: ModelConfig, h0: torch.Tensor,
                xc_chunk: torch.Tensor):
    """One chunk: its (B, chunk, di, ds) tensors, the scan, the output."""
    da_c, dbx_c, c_c = _ssm_params(p, cfg, xc_chunk)
    acc_a, acc_b = _prefix_scan(da_c, dbx_c)
    h_t = acc_a * h0[:, None] + acc_b                       # (B,chunk,di,ds)
    y_c = torch.einsum("blis,bls->bli", h_t, c_c)
    return h_t[:, -1], y_c


def apply_mamba(p: Params, cfg: ModelConfig, x: torch.Tensor,
                state: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B, S, d).  state (decode): {'h': (B,di,ds), 'conv': (B,dc-1,di)}.

    Returns (out, new_state); new_state is None without a state.  A
    multi-token call with a state starts from its h but, as in the
    reference, not from its conv window."""
    b, s_len, d = x.shape
    xz = x @ p["in_proj"]
    xi, z = torch.chunk(xz, 2, dim=-1)                      # (B, S, di) each

    if state is not None and s_len == 1:
        # ---- single-step decode ----
        xc, conv_state = _causal_conv(p, xi, state["conv"])
        d_a, d_bx, c_mat = _ssm_params(p, cfg, xc)
        h = state["h"] * d_a[:, 0] + d_bx[:, 0]             # (B, di, ds)
        y = torch.einsum("bis,bs->bi", h, c_mat[:, 0])[:, None, :]
        new_state = {"h": h, "conv": conv_state}
    else:
        xc, _ = _causal_conv(p, xi)
        chunk = min(SCAN_CHUNK, s_len)
        if s_len % chunk != 0:
            chunk = s_len
        ssm = cfg.ssm or SSMConfig()
        di, ds = ssm.expand * d, ssm.d_state

        recompute = tuning.mamba_fused_params and torch.is_grad_enabled() \
            and xc.requires_grad
        h = (state["h"] if state is not None
             else torch.zeros((b, di, ds), dtype=torch.float32,
                              device=x.device))
        ys = []
        for c0 in range(0, s_len, chunk):
            args = (p, cfg, h, xc[:, c0:c0 + chunk])
            h, y_c = (checkpoint(_chunk_body, *args, use_reentrant=False)
                      if recompute else _chunk_body(*args))
            ys.append(y_c)
        y = torch.cat(ys, dim=1) if len(ys) > 1 else ys[0]
        new_state = None
        if state is not None:
            dconv = p["conv_w"].shape[0]
            xp = F.pad(xi, (0, 0, dconv - 1, 0))
            new_state = {"h": h, "conv": xp[:, -(dconv - 1):, :]}

    y = y + p["D"] * xc.float()
    out = (y * F.silu(z.float())).to(x.dtype)
    return out @ p["out_proj"], new_state


def init_mamba_state(cfg: ModelConfig, batch: int, device) -> Params:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, di, s.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, di), dtype=dtype_of(cfg),
                            device=device),
    }
