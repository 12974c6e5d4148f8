"""Shared model building blocks: the counterpart of `repro.models.common`.

Conventions (the reference's):
  * init_* functions return dicts of tensors, drawn from an explicit
    `torch.Generator` on an explicit device;
  * apply functions are plain functions on tensors; dtype policy: params
    in cfg.dtype, norms and softmax accumulate in float32;
  * weights are (d_in, d_out), so `x @ w` is the reference's product.

Attention has two routes, chosen by `use_kernels`:
  * the kernels (default): a prompt (s > 1 at cache offset 0, or a
    forward without a cache) runs the flash kernel over the prompt's own
    keys, KV heads broadcast by `repeat_interleave`; a decode step
    (s == 1) runs `kernels.ops.paged_attention` over the dense
    (B, S_max, KVH, hd) cache read as a pool of B·S_max/block blocks,
    sequence b's table b·(S_max/block) + j, its length min(pos + 1,
    S_max).  Cross-attention (`kv_x`: keys and values from another
    sequence, no cache, no mask) runs flash for a run of queries and
    paged for one query a sequence, the (B, S_kv, KVH, hd) keys read as
    a pool the same way with every length S_kv.  All compute the
    reference's function: causal keys past the prompt and cache rows
    past pos carry no weight there.  CUDA tensors launch the kernels,
    CPU tensors run their plain versions;
  * the plain attention (`use_kernels=False`): `_sdpa_chunked`, the
    reference's query-chunked softmax over the whole cache, transcribed.

`part=` (a `distributed.partition.RankLayout`) runs a rank's part of the
partitioned step: its query and KV heads, Megatron's f before the
column-parallel products and g after the row-parallel ones, and the
vocab-parallel loss (`lm_loss`).  None is the whole model on one rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention

Params = Dict[str, Any]

ATTN_CHUNK = 1024      # query-chunk size for chunked attention
ATTN_SCORE_BUDGET = 1 << 22   # target elements per (chunk x skv) score slab
PAGED_BLOCK = 16       # tokens a block of the dense cache read as a pool
NEG_INF = -1e30        # the reference's mask fill


def attn_chunk_for(skv: int) -> int:
    """Adapt the query-chunk so the transient score tensor stays bounded:
    32k-KV prefill uses 128-query chunks, 4k training keeps 1024."""
    return int(min(ATTN_CHUNK, max(128, ATTN_SCORE_BUDGET // max(skv, 1))))


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else (1.0 / np.sqrt(d_in))
    w = torch.randn((d_in, d_out), generator=gen, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "ln":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:   # LayerNorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:             # RMSNorm
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (partial rotary supported: StableLM rope_pct=0.25)
# ---------------------------------------------------------------------------

def rope_frequencies(hd_rot: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd_rot, 2, dtype=torch.float32,
                                         device=device) / hd_rot))


def rope_dims(hd: int, rope_pct: float) -> int:
    """Leading lanes of a head that rotate (even; 0 = none)."""
    if rope_pct <= 0.0:
        return 0
    hd_rot = int(hd * rope_pct)
    return hd_rot - hd_rot % 2


def rope_tables(positions: torch.Tensor, hd_rot: int, theta: float):
    """(cos, sin) of shape (..., S, 1, hd_rot/2) in float32: what every
    layer of one forward shares."""
    freqs = rope_frequencies(hd_rot, theta, positions.device)
    angles = positions[..., None].float() * freqs              # (...,S,hr/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0, tables=None) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The
    reference's pairing: lanes 0::2 and 1::2 rotate together and are
    stacked back interleaved (not rotate-half); `x * cos` promotes a
    bfloat16 x to float32, and the result is cast back once.  `tables`:
    `rope_tables(positions, ...)`, when the caller made them already."""
    hd_rot = rope_dims(x.shape[-1], rope_pct)
    if hd_rot == 0:
        return x
    cos, sin = tables if tables is not None else \
        rope_tables(positions, hd_rot, theta)
    x_rot, x_pass = x[..., :hd_rot], x[..., hd_rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rotated = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape)
    return torch.cat([rotated.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA, chunked, optional sliding window / qk-norm)
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, hd = cfg.d_model, cfg.hd
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd, dt, device),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd, dt, device),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd, dt, device),
        "wo": dense_init(gen, cfg.n_heads * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((width * hd,), dtype=dt, device=device)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = {"scale": torch.ones((hd,), dtype=torch.float32,
                                           device=device)}
    return p


def _qk_norm(p, x, eps=1e-6):
    xf = x.float()
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


def _sdpa_chunked(q, k, v, *, causal: bool, window: Optional[int],
                  q_offset, chunk: Optional[int] = None) -> torch.Tensor:
    """softmax(QK^T)V with queries in chunks: the plain attention.

    q: (B, Sq, H, hd)   k/v: (B, Skv, KVH, hd) with H = G*KVH
    q_offset: int, or a (B,) tensor -- position of q[0] within the kv
    timeline.  The reference's masks (-1e30 fill) and float32 math; its
    causal-unrolled variant (`repro.models.tuning`) is bitwise the same
    function."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / np.sqrt(hd)
    qg = q.reshape(b, sq, kvh, g, hd)
    k_idx = torch.arange(skv, device=q.device)

    chunk = min(chunk if chunk is not None else attn_chunk_for(skv), sq)
    n_chunks = sq // chunk if sq % chunk == 0 else 1
    if sq % chunk != 0:
        chunk = sq

    # q_offset may be a scalar (train/prefill) or a (B,) vector (serving
    # slots at different depths); both broadcast to a (B|1, chunk) q_idx
    q_off = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
    kf, vf = k.float(), v.float()
    outs = []
    for ci in range(n_chunks):
        qc = qg[:, ci * chunk:(ci + 1) * chunk].float()
        s = torch.einsum("bqkgd,bskd->bqkgs", qc, kf) * scale
        q_idx = q_off + ci * chunk + torch.arange(chunk,
                                                  device=q.device)[None, :]
        mask = torch.ones(q_idx.shape + (skv,), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_idx[..., None] >= k_idx
        if window is not None:
            mask &= (q_idx[..., None] - k_idx) < window
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bqkgs,bskd->bqkgd", p, vf))
    out = torch.cat(outs, dim=1)
    return out.reshape(b, sq, h, hd)


FLASH_BLOCK = 128       # the reference kernel's (bq, bk)


def flash_block(n: int) -> int:
    """FLASH_BLOCK where it divides n, else n's largest divisor below it
    (1,500 frames -> 125, a 228-token prompt -> 114)."""
    return next(b for b in range(min(n, FLASH_BLOCK), 0, -1) if n % b == 0)


def _flash(q, k, v, *, causal: bool, window: Optional[int]):
    """Attention of (B, Sq, H, hd) queries over (B, Skv, KVH, hd) keys
    through the flash kernel -> (B, Sq, H, hd).

    The kernel computes on a (bq, bk) block grid.  Where the masks make
    the function independent of the grid -- no window, and not causal or
    causal over its own keys from position 0 (every row sees key 0, so
    no row is left with the sentinel alone) -- each block is
    `flash_block` of its length; otherwise the reference's 128 x 128
    grid, which refuses a length over 128 that 128 does not divide."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    if window is None and (not causal or sq == skv):
        bq, bk = flash_block(sq), flash_block(skv)
    else:
        bq = bk = FLASH_BLOCK

    def heads_first(t, n):
        if g > 1 and t is not q:
            t = t.repeat_interleave(g, dim=2)
        return t.transpose(1, 2).contiguous().view(b * h, n, hd)

    out = flash_attention(heads_first(q, sq), heads_first(k, skv),
                          heads_first(v, skv), causal=causal, window=window,
                          bq=bq, bk=bk)
    return out.view(b, h, sq, hd).transpose(1, 2)


@dataclasses.dataclass(frozen=True)
class CacheIndex:
    """Where one forward writes the dense cache, and what its decode
    kernel reads: made once, shared by every layer.

    s > 1: `start`, the write offset (the reference's dynamic update
    slice at pos[0], clamped so the update fits).  s == 1: `rows`, `at`
    (pos clamped to S_max - 1) and `live` (pos < S_max: a slot past the
    end writes nothing, as the reference's one-hot select); on the
    kernel path `tables`, `lengths` (min(pos + 1, S_max)) and `block`,
    the paged view of the cache."""
    start: Optional[int] = None
    rows: Optional[torch.Tensor] = None
    at: Optional[torch.Tensor] = None
    live: Optional[torch.Tensor] = None
    tables: Optional[torch.Tensor] = None
    lengths: Optional[torch.Tensor] = None
    block: int = 0


def cache_index(cache_pos: torch.Tensor, s_max: int, s: int,
                use_kernels: bool, start: Optional[int] = None
                ) -> CacheIndex:
    """`start`: the write offset of a multi-token call when the caller
    knows it (a prefill writes from position 0), so that the positions
    are not read on the host; otherwise a multi-token call reads
    `cache_pos` there."""
    if s > 1:
        offsets = [start] if start is not None else cache_pos.tolist()
        if use_kernels and any(offsets):
            raise ValueError(
                f"a {s}-token call at cache offsets {offsets}: the flash "
                "kernel attends a prompt over its own keys from position 0 "
                "only; run use_kernels=False for a multi-token call at a "
                "nonzero offset")
        return CacheIndex(start=min(max(offsets[0], 0), s_max - s))
    dev = cache_pos.device
    b = cache_pos.shape[0]
    pos = cache_pos.long()
    idx = CacheIndex(rows=torch.arange(b, device=dev),
                     at=pos.clamp(max=s_max - 1), live=pos < s_max)
    if not use_kernels:
        return idx
    return dataclasses.replace(
        kv_index(b, s_max, dev), rows=idx.rows, at=idx.at, live=idx.live,
        lengths=(pos + 1).clamp(max=s_max).to(torch.int32))


def kv_index(b: int, s_kv: int, device) -> CacheIndex:
    """The paged view of B sequences of s_kv keys, each of length s_kv:
    blocks of gcd(s_kv, PAGED_BLOCK) tokens, sequence b's table
    b·(s_kv/block) + j.  Cross-attention's decode route reads its keys
    so; `cache_index` sets the self cache's lengths on top."""
    block = math.gcd(s_kv, PAGED_BLOCK)
    n = s_kv // block
    tables = torch.arange(b * n, dtype=torch.int32, device=device).view(b, n)
    lengths = torch.full((b,), s_kv, dtype=torch.int32, device=device)
    return CacheIndex(tables=tables, lengths=lengths, block=block)


def _write(c: torch.Tensor, new: torch.Tensor, idx: CacheIndex) -> None:
    """New K or V rows (B, s, KVH, hd) into the cache c, in place."""
    new = new.to(c.dtype)
    if idx.start is not None:
        c[:, idx.start:idx.start + new.shape[1]] = new
        return
    keep = c[idx.rows, idx.at]
    c.index_put_((idx.rows, idx.at),
                 torch.where(idx.live[:, None, None], new[:, 0], keep))


def _paged(q, ck, cv, idx: CacheIndex):
    """One query a sequence (B, 1, H, hd) over the dense cache (or cross
    keys) (B, S, KVH, hd) through the paged kernel -> (B, 1, H, hd)."""
    b, _, h, hd = q.shape
    s_max, kvh = ck.shape[1], ck.shape[2]
    shape = (b * s_max // idx.block, idx.block, kvh, hd)
    out = ops.paged_attention(q.reshape(b, h, hd).contiguous(),
                              ck.view(shape), cv.view(shape), idx.tables,
                              idx.lengths)
    return out.reshape(b, 1, h, hd)


def apply_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    kv_x: Optional[torch.Tensor] = None, causal: bool = True,
                    cache: Optional[Params] = None, cache_pos=None,
                    index: Optional[CacheIndex] = None, rope=None,
                    use_kernels: bool = True, part=None):
    """Returns (out, new_cache).  Self-attention unless `kv_x` (B, S_kv,
    d) is given: cross-attention, K and V from kv_x, no RoPE, no cache
    and no causal mask (the reference's `_sdpa_chunked(causal=False)`).

    cache: {'k','v'}: (B, S_max, KVH, hd), written IN PLACE and returned
    (the reference is functional and returns new arrays); cache_pos:
    (B,) write positions.  `index`: `cache_index(...)` -- for
    cross-attention `kv_index(...)` -- and `rope`: `rope_tables(...)`,
    when the caller made them for every layer.  `part`: this rank's query
    and KV heads of the partitioned step (self-attention)."""
    b, s, _ = x.shape
    hd = cfg.hd
    n_q, n_kv = (cfg.n_heads, cfg.n_kv_heads) if part is None \
        else (part.n_q, part.n_kv)
    if part is not None:
        x = part.enter(x)
    src = x if kv_x is None else kv_x
    q = x @ p["wq"]
    k = src @ p["wk"]
    v = src @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, n_q, hd)
    k = k.reshape(b, src.shape[1], n_kv, hd)
    v = v.reshape(b, src.shape[1], n_kv, hd)
    if cfg.qk_norm:
        q = _qk_norm(p["q_norm"], q)
        k = _qk_norm(p["k_norm"], k)
    if kv_x is None and cfg.rope_pct > 0:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct, rope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct, rope)
    if use_kernels and s == 1 and cfg.attn_window is not None \
            and (cache is not None or kv_x is not None):
        raise ValueError(
            f"attn_window={cfg.attn_window}: the paged decode kernel "
            "has no window mask; decode with use_kernels=False")

    new_cache = None
    if kv_x is not None:
        if cache is not None:
            raise ValueError("cross-attention (kv_x) takes no cache")
        if not use_kernels:
            out = _sdpa_chunked(q, k, v, causal=False,
                                window=cfg.attn_window, q_offset=0)
        elif s > 1:
            out = _flash(q, k, v, causal=False, window=cfg.attn_window)
        else:
            out = _paged(q, k, v, index if index is not None else
                         kv_index(b, k.shape[1], x.device))
    elif cache is None:
        if use_kernels:
            out = _flash(q, k, v, causal=causal, window=cfg.attn_window)
        else:
            out = _sdpa_chunked(q, k, v, causal=causal,
                                window=cfg.attn_window, q_offset=0)
    else:
        ck, cv = cache["k"], cache["v"]
        if index is None:
            index = cache_index(cache_pos, ck.shape[1], s, use_kernels)
        _write(ck, k, index)
        _write(cv, v, index)
        new_cache = {"k": ck, "v": cv}
        if not use_kernels:
            out = _sdpa_chunked(q, ck, cv, causal=True,
                                window=cfg.attn_window, q_offset=cache_pos)
        elif s > 1:
            out = _flash(q, k.to(ck.dtype), v.to(cv.dtype), causal=True,
                         window=cfg.attn_window)
        else:
            out = _paged(q, ck, cv, index)
    out = out.to(x.dtype).reshape(b, s, n_q * hd) @ p["wo"]
    return (out if part is None else part.leave(out)), new_cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: Optional[int] = None) -> Params:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    p = {"w_up": dense_init(gen, d, ff, dt, device),
         "w_down": dense_init(gen, ff, d, dt, device)}
    if cfg.act == "swiglu":
        p["w_gate"] = dense_init(gen, d, ff, dt, device)
    return p


def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor, part=None
              ) -> torch.Tensor:
    if part is not None:
        x = part.enter(x)
    up = x @ p["w_up"]
    if cfg.act == "swiglu":
        up = F.silu(x @ p["w_gate"]) * up
    else:
        up = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    out = up @ p["w_down"]
    return out if part is None else part.leave(out)


# ---------------------------------------------------------------------------
# Loss (chunked over sequence)
# ---------------------------------------------------------------------------

def lm_loss(head: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
            n_chunks: int = 8, part=None) -> torch.Tensor:
    """Cross-entropy( x @ head , labels ) without materializing full logits.

    x: (B, S, d), head: (d, V), labels: (B, S) int (-1 = masked).
    Chunked over S: transient logits are (B, S/n_chunks, V).  `part`:
    vocab-parallel over this rank's (d, V / model) head block -- the
    log-sum-exp shifted by the `pmax` of the blocks' maxima, its
    exponentials summed over `model`, the gold logit from the rank that
    holds the label -- and the total and count summed over `dp`: the
    global mean on every rank."""
    b, s, _ = x.shape
    if s % n_chunks != 0:
        n_chunks = 1
    cs = s // n_chunks
    if part is not None:
        x = part.enter(x)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        xi, li = x[:, c * cs:(c + 1) * cs], labels[:, c * cs:(c + 1) * cs]
        logits = (xi @ head).float()                   # (B, cs, V)
        if part is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = logits.gather(-1, li.clamp(min=0).long()[..., None])
            gold = gold[..., 0]
        else:
            m = part.vocab_max(logits.amax(-1))
            logz = m + torch.log(part.vocab_sum(
                torch.exp(logits - m[..., None]).sum(-1)))
            local = li.long() - part.vocab0
            mine = (local >= 0) & (local < part.n_vocab)
            idx = local.clamp(0, part.n_vocab - 1)[..., None]
            g = logits.gather(-1, idx)
            gold = part.vocab_sum(torch.where(mine, g[..., 0], 0.0))
        valid = (li >= 0).float()
        tot = tot + ((logz - gold) * valid).sum()
        cnt = cnt + valid.sum()
    if part is not None:
        tot, cnt = part.dp_sum(tot), part.dp_sum(cnt)
    return tot / cnt.clamp(min=1.0)

