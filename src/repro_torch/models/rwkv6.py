"""RWKV-6 (Finch) block: the counterpart of `repro.models.rwkv6`.

Attention-free time mix with a data-dependent decay: token-shift lerp
with learned mixes, a low-rank decay w_t = exp(-exp(w0 + tanh(x A) B)),
a per-head wkv state S in R^{hd x hd} with bonus u, and a squared-ReLU
channel mix.  Decode state is O(1) in the context length.

Two branches of the wkv recurrence, chosen as the reference chooses
them: a sequence whose length is a multiple of 256 (and at least 256)
with `tuning.rwkv_chunked_scan` on runs the two-level chunked form
(`_wkv_chunked`: 256-token super-chunks, recomputed in the backward
pass, over 32-token factored sub-chunks whose intra-chunk work is two
(C x C) products); any other length runs the per-token recurrence.
`_LW_CLIP` floors the factored term's per-step log-decay only, and
changes the result: it is the reference's constant.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from . import tuning
from .common import dense_init, dtype_of

Params = Dict[str, Any]

CHUNK = 256        # super-chunk length of the chunked branch
_SUB = 32          # factored sub-chunk length
_LW_CLIP = -2.6    # per-step log-decay floor for the factored term only


def init_rwkv_time(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, hd = cfg.d_model, cfg.hd
    h = d // hd
    dt = dtype_of(cfg)
    lora = max(32, d // 32)

    def half():
        return torch.full((d,), 0.5, dtype=dt, device=device)

    p = {"mix_r": half(), "mix_k": half(), "mix_v": half(),
         "mix_w": half(), "mix_g": half()}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = dense_init(gen, d, d, dt, device)
    p["w0"] = torch.zeros((d,), dtype=torch.float32, device=device)
    p["wA"] = dense_init(gen, d, lora, dt, device, scale=0.01)
    p["wB"] = dense_init(gen, lora, d, dt, device, scale=0.01)
    p["u"] = torch.randn((h, hd), generator=gen, device=device) * 0.1
    p["ln_x"] = {"scale": torch.ones((d,), dtype=torch.float32,
                                     device=device),
                 "bias": torch.zeros((d,), dtype=torch.float32,
                                     device=device)}
    return p


def init_rwkv_channel(gen: torch.Generator, cfg: ModelConfig,
                      device) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "mix_k": torch.full((d,), 0.5, dtype=dt, device=device),
        "mix_r": torch.full((d,), 0.5, dtype=dt, device=device),
        "wk": dense_init(gen, d, ff, dt, device),
        "wv": dense_init(gen, ff, d, dt, device),
        "wr": dense_init(gen, d, d, dt, device),
    }


def _group_norm(p, x, h, eps=1e-5):
    """Per-head layernorm on (B, S, d) viewed as (B, S, H, hd)."""
    b, s, d = x.shape
    xf = x.reshape(b, s, h, -1).float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return xf.reshape(b, s, d) * p["scale"] + p["bias"]


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """The x_{t-1} stream: x shifted right by one; `last` supplies t = -1
    (decode), zeros otherwise."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _wkv_tokens(r, k, v, w, u, s0):
    """The per-token recurrence.  r/k/v/w: (B, S, H, hd) float32.

    The reference's out_t = r_t (S + diag(u) k_t v_t^T), regrouped as
    r_t S + <r_t u, k_t> v_t: the bonus term of every step is one
    product outside the loop, which leaves two kernels a step (r_t S and
    S_t = diag(w_t) S + k_t v_t^T as one addcmul)."""
    bonus = (r * u * k).sum(-1, keepdim=True) * v
    s_carry = s0
    outs = []
    for t in range(r.shape[1]):
        outs.append(torch.matmul(r[:, t, :, None, :], s_carry)[..., 0, :])
        s_carry = torch.addcmul(k[:, t, :, :, None] * v[:, t, :, None, :],
                                w[:, t, :, :, None], s_carry)
    return s_carry, torch.stack(outs, dim=1) + bonus


def apply_rwkv_time(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    state: Optional[Params] = None
                    ) -> Tuple[torch.Tensor, Optional[Params]]:
    """x: (B,S,d); state: {'S': (B,H,hd,hd), 'last': (B,d)} for decode."""
    b, s, d = x.shape
    hd = cfg.hd
    h = d // hd
    last = state["last"] if state is not None else None
    dx = _token_shift(x, last) - x          # each lerp's (prev - x)

    def lerp(mix):
        return x + dx * mix

    r = (lerp(p["mix_r"]) @ p["wr"]).reshape(b, s, h, hd)
    k = (lerp(p["mix_k"]) @ p["wk"]).reshape(b, s, h, hd)
    v = (lerp(p["mix_v"]) @ p["wv"]).reshape(b, s, h, hd)
    g = F.silu(lerp(p["mix_g"]) @ p["wg"])
    # data-dependent decay in (0, 1): w = exp(-exp(...))  (Finch eq. 4)
    w_log = p["w0"] + (torch.tanh(lerp(p["mix_w"]) @ p["wA"])
                       @ p["wB"]).float()

    rf, kf, vf = r.float(), k.float(), v.float()
    s0 = (state["S"] if state is not None
          else torch.zeros((b, h, hd, hd), dtype=torch.float32,
                           device=x.device))
    if tuning.rwkv_chunked_scan and s % CHUNK == 0 and s >= CHUNK:
        log_w = -torch.exp(w_log).reshape(b, s, h, hd)       # log w_t < 0
        s_last, out = _wkv_chunked(rf, kf, vf, log_w, p["u"], s0, CHUNK)
    else:
        w = torch.exp(-torch.exp(w_log)).reshape(b, s, h, hd)
        s_last, out = _wkv_tokens(rf, kf, vf, w, p["u"], s0)
    out = _group_norm(p["ln_x"], out.reshape(b, s, d), h)
    out = (out * g.float()).to(x.dtype) @ p["wo"]
    new_state = None
    if state is not None:
        new_state = {"S": s_last, "last": x[:, -1, :]}
    return out, new_state


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum along `dim` (at most 256 long) in XLA's CPU order,
    the reference's: sequential float32 sums within blocks of 16, plus
    the sequential sum of the blocks before.  A cumulative log-decay
    feeds exp() at up to 83 in magnitude, so its rounding shows: torch's
    CPU cumsum accumulates in float64 and differs by an ulp of 83.  On
    the card `torch.cumsum` along an outer dim is a sequential float32
    loop; on the CPU an explicit one is."""
    def seq(t):
        if t.is_cuda:
            return torch.cumsum(t, 1)
        out = [t[:, 0]]
        for i in range(1, t.shape[1]):
            out.append(out[-1] + t[:, i])
        return torch.stack(out, dim=1)

    x = x.movedim(dim, 1)
    n = x.shape[1]
    if n <= 16 or n % 16:
        return seq(x).movedim(1, dim)
    pre = seq(x.reshape((x.shape[0], n // 16, 16) + x.shape[2:])
              .transpose(1, 2)).transpose(1, 2)         # within blocks
    sums = pre[:, :, -1]
    off = torch.cat([torch.zeros_like(sums[:, :1]), seq(sums)[:, :-1]],
                    dim=1)
    return (pre + off[:, :, None]).reshape(x.shape).movedim(1, dim)


def _wkv_subchunks(s_carry, r, k, v, lw, u):
    """n factored sub-chunks of the recurrence in order.  r/k/v/lw:
    (B, n, C, H, hd) float32, C = _SUB steps a sub-chunk; returns (S
    after the last, out (B, n, C, H, hd)).  With cum_t = sum_{i<=t}
    log w_i within a sub-chunk:
        out_t = (r_t exp(cum_{t-1})) @ S_0
              + sum_{i<t} <r_t exp(cum_{t-1}), k_i exp(-cum_i)> v_i
              + <r_t u, k_t> v_t
        S_out = diag(exp(cum_C)) S_0 + (k exp(cum_C - cum))^T V
    The intra-chunk factors use the floored log-decay (`_LW_CLIP`); the
    inter-chunk and state terms the exact one.  Every term but the
    carry's is computed for all n sub-chunks at once; the carry then
    takes two kernels a sub-chunk (one baddbmm, one addcmul)."""
    b, n, c, h, d = r.shape
    lw_f = torch.clamp(lw, min=_LW_CLIP)
    cum = _cumsum(lw, 2)                                    # exact
    cum_f = _cumsum(lw_f, 2)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=r.device), -1)      # strict lower

    def heads(x):                                           # (n,B,H,C,hd)
        return x.permute(1, 0, 3, 2, 4)

    r_dec = heads(r * torch.exp(cum_f - lw_f))              # <= 1
    k_inv = heads(k * torch.exp(-cum_f))                    # <= e^83
    scores = torch.matmul(r_dec, k_inv.transpose(-1, -2))   # (n,B,H,C,C)
    scores = torch.where(mask, scores, scores.new_zeros(()))
    vh = heads(v)
    bonus = (r * u * k).sum(-1, keepdim=True) * v
    base = (torch.matmul(scores, vh) + heads(bonus)).contiguous()
    r_exact = heads(r * torch.exp(cum - lw)).contiguous()   # cum_{t-1}
    total = cum[:, :, -1:]                                  # (B,n,1,H,hd)
    k2 = heads(k * torch.exp(total - cum))                  # exact, <= 1
    kv = torch.matmul(k2.transpose(-1, -2), vh)             # (n,B,H,hd,hd)
    decay = torch.exp(total[:, :, 0]).permute(1, 0, 2, 3)[..., None]
    outs = []
    for j in range(n):
        outs.append(torch.baddbmm(base[j].view(b * h, c, d),
                                  r_exact[j].view(b * h, c, d),
                                  s_carry.reshape(b * h, d, d)))
        s_carry = torch.addcmul(kv[j], decay[j], s_carry)
    out = torch.stack(outs).view(n, b, h, c, d).permute(1, 0, 3, 2, 4)
    return s_carry, out


def _wkv_subchunk(s_carry, rc, kc, vc, lwc, u):
    """One factored sub-chunk, the reference's unit: r/k/v/lwc (B, C, H,
    hd) -> (S after it, out (B, C, H, hd))."""
    s_new, out = _wkv_subchunks(s_carry, rc[:, None], kc[:, None],
                                vc[:, None], lwc[:, None], u)
    return s_new, out[:, 0]


def _super_chunk(s_carry, rc, kc, vc, lwc, u):
    b, c, h, d = rc.shape

    def subs(x):
        return x.reshape(b, c // _SUB, _SUB, h, d)

    s_carry, out = _wkv_subchunks(s_carry, subs(rc), subs(kc), subs(vc),
                                  subs(lwc), u)
    return s_carry, out.reshape(b, c, h, d)


def _wkv_chunked(r, k, v, log_w, u, s0, chunk: int):
    """The two-level chunked recurrence.  r/k/v/log_w: (B, S, H, hd)
    float32, log_w < 0; u: (H, hd); s0: (B, H, hd, hd).  Returns
    (s_last, out (B, S, H, hd)).  Under autograd each super-chunk is
    recomputed in the backward pass, so only its boundary state is
    saved."""
    recompute = torch.is_grad_enabled() and r.requires_grad
    s_carry = s0
    outs = []
    for c0 in range(0, r.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        args = (s_carry, r[:, sl], k[:, sl], v[:, sl], log_w[:, sl], u)
        if recompute:
            s_carry, out = checkpoint(_super_chunk, *args,
                                      use_reentrant=False)
        else:
            s_carry, out = _super_chunk(*args)
        outs.append(out)
    return s_carry, torch.cat(outs, dim=1)


def apply_rwkv_channel(p: Params, cfg: ModelConfig, x: torch.Tensor,
                       state: Optional[Params] = None
                       ) -> Tuple[torch.Tensor, Optional[Params]]:
    last = state["last"] if state is not None else None
    dx = _token_shift(x, last) - x
    xk = x + dx * p["mix_k"]
    xr = x + dx * p["mix_r"]
    k = torch.square(torch.relu(xk @ p["wk"]))
    out = torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])
    new_state = {"last": x[:, -1, :]} if state is not None else None
    return out, new_state


def init_rwkv_state(cfg: ModelConfig, batch: int, device) -> Params:
    d, hd = cfg.d_model, cfg.hd
    h = d // hd
    dt = dtype_of(cfg)
    return {
        "time": {"S": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                                  device=device),
                 "last": torch.zeros((batch, d), dtype=dt, device=device)},
        "channel": {"last": torch.zeros((batch, d), dtype=dt,
                                        device=device)},
    }
