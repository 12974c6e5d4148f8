"""The port's attention slice against the reference: flash and paged
attention (the kernels' plain versions on the CPU against the Pallas
kernels in interpret mode), the `ops` entry points with GQA, the `ref`
oracles, and the paged KV pool (`serve/kv_blocks.py`).

Inputs are made once with numpy from a seed and handed to both packages.
Tolerances: float32 rtol = atol = 1e-5 (the reference's own tests use
2e-4; both sides accumulate in float32 and differ only in summation
order); bfloat16 outputs within one bfloat16 ulp of each other, taken
at |value| >= 2^-8 (both round the same float32 function of the same
bfloat16 inputs once; `_torch_parity.within_bf16_ulp`); the
reference's 5e-2 where a bfloat16 result is held to a float32 oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import within_bf16_ulp

from repro.kernels import ops as jops, ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro.serve import kv_blocks as jkv
from repro_torch.kernels import (flash_attention, flash_attention_plain,
                                 ops, paged_attention, paged_attention_plain,
                                 ref)
from repro_torch.kernels.paged_attention import CHUNK, split_plan
from repro_torch.serve import kv_blocks as tkv

F32 = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(bh, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(bh, sq, d)).astype(np.float32),
            rng.normal(size=(bh, skv, d)).astype(np.float32),
            rng.normal(size=(bh, skv, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    (128, 128, 64, True, None),      # tests/test_kernels.py's sweep
    (256, 256, 64, True, 64),
    (128, 256, 64, False, None),     # cross-attention shape
    (256, 256, 128, True, None),
    (256, 256, 64, True, 32),        # the banded-mask test
    (256, 128, 64, False, 64),       # rows 191-255 see no key
    (256, 256, 64, False, 100),      # window only, ragged in the blocks
    (64, 256, 64, True, None),       # bq = sq = 64 < 128
]


@pytest.mark.parametrize("sq,skv,d,causal,window", FLASH_CASES)
def test_flash_matches_the_pallas_kernel(sq, skv, d, causal, window):
    q, k, v = _qkv(2, sq, skv, d, seed=8)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == (2, sq, d)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("bq,bk", [(64, 64), (32, 128), (128, 32)])
def test_flash_block_sizes_match_the_pallas_kernel(bq, bk):
    """Other (bq, bk) grids change which blocks are relevant and so the
    fully masked rows' values; the port follows the grid it is given."""
    q, k, v = _qkv(1, 256, 128, 64, seed=11)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False, window=40,
                                  bq=bq, bk=bk)
    got = flash_attention(_t(q), _t(k), _t(v), causal=False, window=40,
                          bq=bq, bk=bk)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_flash_fully_masked_rows_are_the_kernels_mean_of_v():
    """sq 256, skv 128, window 64, not causal: rows 191-255 have no
    visible key but their 128-key block is relevant, so the kernel gives
    the mean of v over it; the oracle gives 0 there."""
    q, k, v = _qkv(2, 256, 128, 64, seed=3)
    got = flash_attention(_t(q), _t(k), _t(v), causal=False, window=64)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False, window=64)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    mean_v = v.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(_np(got)[:, 191:], np.broadcast_to(
        mean_v, (2, 65, 64)), **F32)
    oracle = ref.mha_ref(_t(q), _t(k), _t(v), causal=False, window=64)
    assert np.all(_np(oracle)[:, 191:] == 0.0)
    assert not np.allclose(_np(got)[:, 191:], 0.0)
    np.testing.assert_allclose(_np(got)[:, :191], _np(oracle)[:, :191], **F32)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, 64)])
def test_flash_bf16_within_one_ulp_of_the_pallas_kernel(causal, window):
    q, k, v = _qkv(2, 256, 128 if not causal else 256, 64, seed=9)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = flash_attention_pallas(qb, kb, vb, causal=causal, window=window)
    got = flash_attention(*(_t(np.asarray(a, np.float32), torch.bfloat16)
                            for a in (qb, kb, vb)),
                          causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    assert within_bf16_ulp(_np(got), _np(want))
    # and the reference's own bound against the float32 oracle
    oracle = ref.mha_ref(_t(q), _t(k), _t(v), causal=causal, window=window)
    if window is None or causal:
        np.testing.assert_allclose(_np(got), _np(oracle), rtol=5e-2,
                                   atol=5e-2)


def _bf16_kernel_rounding(q, k, v, split, bk=128):
    """The bfloat16 CUDA kernel's arithmetic, causal, in plain torch: the
    online softmax over bk-key tiles in float32, l summed from the
    float32 p, and p·v on the tensor cores' bfloat16 operands -- p split
    into hi = bf16(p) and lo = bf16(p - hi) (`split`), or p rounded to
    bf16 once.  Every row sees key 0 in the first tile, so the pairs a
    causal mask hides contribute 0, as the sentinel gives them there."""
    bh, sq, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    rows = torch.arange(sq)[:, None]
    for c0 in range(0, k.shape[1], bk):
        s = qf @ kf[:, c0:c0 + bk].transpose(1, 2) / d ** 0.5
        s = torch.where(rows >= torch.arange(c0, c0 + bk)[None, :], s,
                        -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vf[:, c0:c0 + bk]
        if split:
            pv = pv + (p - hi).bfloat16().float() @ vf[:, c0:c0 + bk]
        acc = acc * corr + pv
        m = m_new
    return (acc / l).bfloat16()


def test_flash_bf16_kernel_needs_the_lo_term_of_p():
    """Why the bfloat16 kernel carries p's lo term: with it the kernel's
    rounding stays within one bf16 ulp of the float32 plain version;
    with p rounded to bf16 once, as the usual tensor-core design does,
    it does not (bh 8, 1024 tokens, d 128, causal)."""
    q, k, v = (_t(a, torch.bfloat16) for a in _qkv(8, 1024, 1024, 128, 0))
    want = flash_attention_plain(q, k, v, causal=True)
    assert within_bf16_ulp(_bf16_kernel_rounding(q, k, v, split=True), want)
    assert not within_bf16_ulp(_bf16_kernel_rounding(q, k, v, split=False),
                               want)


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to the nearest of the 10
    stored mantissa bits, ties away from zero."""
    u = x.float().contiguous().view(torch.int32).long()
    return ((u + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def _split3(a, b, terms):
    """a @ b as the float32 kernel's tensor cores take it: 3xTF32 (lo·hi +
    hi·lo, then hi·hi, each summed in float32) or, with terms=1, hi·hi
    alone."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _f32_kernel_rounding(q, k, v, terms, bk):
    """The float32 CUDA kernel's arithmetic, causal, in plain torch: the
    online softmax over bk-key tiles in float32, S = Q Kᵀ and P V each on
    the tensor cores' tf32 operands (`_split3`), P split from the float32
    p, l summed from the float32 p, the scale on the float32 scores."""
    bh, sq, d = q.shape
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    rows = torch.arange(sq)[:, None]
    for c0 in range(0, k.shape[1], bk):
        s = _split3(q, k[:, c0:c0 + bk].transpose(1, 2), terms) / d ** 0.5
        s = torch.where(rows >= torch.arange(c0, c0 + bk)[None, :], s,
                        -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + _split3(p, v[:, c0:c0 + bk], terms)
        m = m_new
    return acc / l


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.0e38,
                      float("inf")])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9,
                         -(1.0 + 2 ** -10), 1.0, float("inf"),
                         float("inf")])
    got = _tf32(x)
    assert torch.equal(got[:5], want[:5])
    assert got[6] == float("inf")
    # hi + lo carries 21 of float32's 24 bits
    r = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi = _tf32(r)
    err = (hi + _tf32(r - hi) - r).abs() / r.abs()
    assert float(err.max()) < 2 ** -21


@pytest.mark.parametrize("bk", [32, 128])
def test_flash_f32_kernel_needs_three_tf32_products(bk):
    """Why the float32 kernel takes three TF32 products a product: with
    them the kernel's rounding holds the card's float32 check (rtol 1e-4,
    atol 1e-5) against the float32 plain version; with one, as TF32
    alone gives, it does not (bh 8, 1024 tokens, d 128, causal; the
    kernel's 32-key tiles and the reference's 128)."""
    q, k, v = (_t(a) for a in _qkv(8, 1024, 1024, 128, 0))
    want = flash_attention_plain(q, k, v, causal=True)
    three = _f32_kernel_rounding(q, k, v, terms=3, bk=bk)
    one = _f32_kernel_rounding(q, k, v, terms=1, bk=bk)
    assert torch.allclose(three, want, rtol=1e-4, atol=1e-5)
    assert not torch.allclose(one, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sq,skv", [(200, 128), (128, 200), (384, 320)])
def test_flash_refuses_what_the_reference_asserts(sq, skv):
    q, k, v = _qkv(1, sq, skv, 64, seed=0)
    with pytest.raises(AssertionError):
        flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v))
    with pytest.raises(ValueError):
        flash_attention(_t(q), _t(k), _t(v))


def test_flash_refuses_mixed_dtypes():
    q, k, v = _qkv(1, 128, 128, 64, seed=0)
    with pytest.raises(ValueError):
        flash_attention(_t(q), _t(k, torch.bfloat16), _t(v))


@pytest.mark.parametrize("kvh", [8, 2])
def test_ops_flash_attention_with_broadcast_kv_heads(kvh):
    """(batch, heads, seq, hd) through `ops`, KV heads broadcast by the
    caller: `repeat_interleave` on the port, `jnp.repeat` on the
    reference."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 8, 128, 64)).astype(np.float32)
    k = rng.normal(size=(2, kvh, 128, 64)).astype(np.float32)
    v = rng.normal(size=(2, kvh, 128, 64)).astype(np.float32)
    g = 8 // kvh
    want = jops.flash_attention(jnp.asarray(q),
                                jnp.repeat(jnp.asarray(k), g, axis=1),
                                jnp.repeat(jnp.asarray(v), g, axis=1),
                                causal=True, window=32)
    got = ops.flash_attention(_t(q), _t(k).repeat_interleave(g, dim=1),
                              _t(v).repeat_interleave(g, dim=1),
                              causal=True, window=32)
    assert got.shape == (2, 8, 128, 64)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (128, 128, True, None), (256, 256, True, 32), (256, 128, False, 64),
    (128, 256, False, None)])
def test_mha_ref_matches_the_reference_oracle(sq, skv, causal, window):
    q, k, v = _qkv(2, sq, skv, 64, seed=12)
    want = jref.mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window)
    got = ref.mha_ref(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------

def _paged(bsz=3, h=4, kvh=None, hd=32, n_blocks=16, block=8, max_blocks=4,
           seed=0):
    """The scheme of tests/test_paged_attention.py's `_setup` (distinct
    physical blocks per sequence), with KVH pool heads."""
    rng = np.random.default_rng(seed)
    kvh = h if kvh is None else kvh
    q = rng.normal(size=(bsz, h, hd)).astype(np.float32)
    kp = rng.normal(size=(n_blocks, block, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(n_blocks, block, kvh, hd)).astype(np.float32)
    perm = rng.permutation(n_blocks)[: bsz * max_blocks]
    tables = perm.reshape(bsz, max_blocks).astype(np.int32)
    lengths = rng.integers(1, max_blocks * block + 1, bsz).astype(np.int32)
    return q, kp, vp, tables, lengths


def _both(q, kp, vp, tables, lengths, dtype=np.float32):
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = jops.paged_attention(*(jnp.asarray(a).astype(jd)
                                  for a in (q, kp, vp)),
                                jnp.asarray(tables), jnp.asarray(lengths))
    got = paged_attention(*(_t(a, td) for a in (q, kp, vp)),
                          _t(tables), _t(lengths))
    return got, want


@pytest.mark.parametrize("bsz,h,hd,block", [
    (2, 4, 32, 8), (3, 8, 64, 16), (1, 2, 128, 8)])
def test_paged_matches_the_pallas_kernel(bsz, h, hd, block):
    got, want = _both(*_paged(bsz=bsz, h=h, hd=hd, block=block))
    assert got.shape == (bsz, h, hd)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("h,kvh", [(8, 2), (32, 8), (4, 1)])
def test_paged_gqa_matches_the_broadcast_reference(h, kvh):
    """The port maps query head h to KV head h // (H / KVH) inside the
    kernel; the reference repeats the pools' heads first."""
    got, want = _both(*_paged(bsz=2, h=h, kvh=kvh, hd=32, seed=1))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    got_ops = ops.paged_attention(*(_t(a) for a in _paged(
        bsz=2, h=h, kvh=kvh, hd=32, seed=1)))
    np.testing.assert_allclose(_np(got_ops), _np(want), **F32)


def test_paged_bf16_within_one_ulp_of_the_pallas_kernel():
    args = _paged(seed=2)
    got, want = _both(*args, dtype="bf16")
    assert got.dtype == torch.bfloat16
    assert within_bf16_ulp(_np(got), _np(want))
    oracle = ref.paged_attention_ref(*(_t(a) for a in args))
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=5e-2, atol=5e-2)


def test_paged_length_zero_is_zero():
    """Length 0 walks no block: the kernel gives 0 (the oracle gives a
    uniform softmax over the padded table)."""
    q, kp, vp, tables, _ = _paged(bsz=2, seed=4)
    lengths = np.array([0, 9], np.int32)
    got, want = _both(q, kp, vp, tables, lengths)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert np.all(_np(got)[0] == 0.0)
    oracle = ref.paged_attention_ref(*(_t(a) for a in
                                       (q, kp, vp, tables, lengths)))
    assert np.abs(_np(oracle)[0]).max() > 0.1


def test_paged_ignores_stale_table_entries():
    """Entries past ceil(length / block) set to other valid blocks change
    nothing, in the reference kernel as in the port."""
    q, kp, vp, tables, lengths = _paged(bsz=3, n_blocks=16, block=8,
                                        max_blocks=4, seed=6)
    lengths = np.array([5, 9, 17], np.int32)
    stale = tables.copy()
    for b, ln in enumerate(lengths):
        stale[b, -(-ln // 8):] = (tables[b, 0] + 7) % 16
    base, want = _both(q, kp, vp, tables, lengths)
    got, want_stale = _both(q, kp, vp, stale, lengths)
    np.testing.assert_allclose(_np(want_stale), _np(want), rtol=0, atol=0)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert torch.equal(got, base)


def test_paged_never_reads_past_the_walked_blocks():
    """A table entry past the walked blocks may even lie outside the
    pool: the port never dereferences it.  One inside them that lies
    outside the pool makes that sequence NaN."""
    q, kp, vp, tables, _ = _paged(bsz=2, seed=7)
    lengths = np.array([8, 20], np.int32)
    far = tables.copy()
    far[0, 1:] = 10 ** 6
    far[1, 3] = -5
    base = paged_attention(*(_t(a) for a in (q, kp, vp, tables, lengths)))
    got = paged_attention(*(_t(a) for a in (q, kp, vp, far, lengths)))
    assert torch.equal(got, base)
    far[1, 2] = 16
    got = paged_attention(*(_t(a) for a in (q, kp, vp, far, lengths)))
    assert torch.equal(got[0], base[0]) and torch.isnan(got[1]).all()


def test_paged_respects_lengths():
    """Poisoning K past each sequence's length within its blocks changes
    nothing (tests/test_paged_attention.py's check)."""
    q, kp, vp, tables, _ = _paged(seed=3)
    lengths = np.array([5, 9, 17], np.int32)
    kp2 = kp.copy()
    for b in range(3):
        for j, blk in enumerate(tables[b]):
            kp2[blk, max(int(lengths[b]) - j * 8, 0):] = 1e3
    a = paged_attention(*(_t(x) for x in (q, kp, vp, tables, lengths)))
    b = paged_attention(*(_t(x) for x in (q, kp2, vp, tables, lengths)))
    np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def test_paged_with_allocator_tables():
    """End to end with both allocators' tables (identical) and a pool
    written through `write_token`."""
    cfg = (16, 8, 4)
    jal = jkv.BlockAllocator(jkv.PoolConfig(*cfg))
    tal = tkv.BlockAllocator(tkv.PoolConfig(*cfg))
    for al in (jal, tal):
        al.admit(0, 20)
        al.admit(1, 7)
    jt = np.stack([jal.table_array(0), jal.table_array(1)])
    tt = np.stack([tal.table_array(0), tal.table_array(1)])
    assert np.array_equal(jt, tt) and tt.dtype == np.int32
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 4, 32)).astype(np.float32)
    kp = rng.normal(size=(16, 8, 4, 32)).astype(np.float32)
    vp = rng.normal(size=(16, 8, 4, 32)).astype(np.float32)
    lengths = np.array([20, 7], np.int32)
    got, want = _both(q, kp, vp, tt, lengths)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_paged_refuses_bad_shapes_and_dtypes():
    q, kp, vp, tables, lengths = _paged(h=4, kvh=4)
    with pytest.raises(ValueError):           # 3 KV heads do not divide 4
        paged_attention(_t(q), _t(kp[:, :, :3]), _t(vp[:, :, :3]),
                        _t(tables), _t(lengths))
    with pytest.raises(ValueError):
        paged_attention(_t(q), _t(kp, torch.bfloat16), _t(vp),
                        _t(tables), _t(lengths))
    with pytest.raises(ValueError):
        paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lengths[:2]))


def _split_walk_model(q, kp, vp, tables, lengths, span, chunk=CHUNK):
    """The paged CUDA kernel's split walk in plain torch: per sequence and
    KV head, each span of `span` tokens below the length runs the online
    softmax over `chunk`-token chunks into a partial (m, l, acc); the
    spans then fold in split order (m = max mᵢ, l = Σ lᵢ·e^(mᵢ-m), acc =
    Σ accᵢ·e^(mᵢ-m)), 0 where no span was walked, NaN for the sequence if
    any walked table entry of any span lies outside the pool."""
    bsz, h, hd = q.shape
    n_blocks, block, kvh, _ = kp.shape
    g = h // kvh
    n_pos = tables.shape[1] * block
    out = torch.zeros((bsz, h, hd))
    for b in range(bsz):
        n_tok = min(max(int(lengths[b]), 0), n_pos)
        parts, bad = [], False
        for s0 in range(0, n_tok, span):
            n_here = min(span, n_tok - s0)
            ids = tables[b, s0 // block:s0 // block - (-n_here // block)]
            if ((ids < 0) | (ids >= n_blocks)).any():
                bad = True
                continue
            pos = torch.arange(s0, s0 + n_here)
            rows = ids.long()[(pos - s0) // block], pos % block
            k_all = kp[rows].float().transpose(0, 1)        # (kvh, t, hd)
            v_all = vp[rows].float().transpose(0, 1)
            qf = q[b].float().reshape(kvh, g, hd)
            m = torch.full((kvh, g, 1), -1e30)
            l = torch.zeros((kvh, g, 1))
            acc = torch.zeros((kvh, g, hd))
            for c0 in range(0, n_here, chunk):
                kc, vc = k_all[:, c0:c0 + chunk], v_all[:, c0:c0 + chunk]
                sc = qf @ kc.transpose(1, 2) / hd ** 0.5
                m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
                p = torch.exp(sc - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                acc = acc * corr + p @ vc
                m = m_new
            parts.append((m, l, acc))
        if bad:
            out[b] = float("nan")
        elif parts:
            m = torch.stack([p[0] for p in parts]).amax(dim=0)
            l = sum(p[1] * torch.exp(p[0] - m) for p in parts)
            acc = sum(p[2] * torch.exp(p[0] - m) for p in parts)
            out[b] = (acc / l).reshape(h, hd)
    return out


SPAN, BLOCK, MAX_BLOCKS = 64, 8, 16          # two spans of two chunks


def _split_case(lengths, seed=0, kvh=2, h=8, hd=32):
    return _paged(bsz=len(lengths), h=h, kvh=kvh, hd=hd, n_blocks=160,
                  block=BLOCK, max_blocks=MAX_BLOCKS, seed=seed)[:4] + (
        np.array(lengths, np.int32),)


@pytest.mark.parametrize("lengths", [
    [0, 1, SPAN - 1, SPAN, SPAN + 1, MAX_BLOCKS * BLOCK],
    [SPAN + 31, SPAN + 32, SPAN + 33, 2 * SPAN - 1, -3, 17]])
def test_split_walk_model_matches_plain_and_pallas(lengths):
    """The kernel's split walk and ordered merge give the plain version's
    and the Pallas kernel's result (interpret mode, KV heads broadcast as
    `ops` does), lengths across the span and chunk edges included."""
    q, kp, vp, tables, lens = _split_case(lengths)
    got = _split_walk_model(*(_t(a) for a in (q, kp, vp, tables, lens)),
                            span=SPAN)
    plain = paged_attention_plain(*(_t(a) for a in
                                    (q, kp, vp, tables, lens)))
    g = q.shape[1] // kp.shape[2]
    want = paged_attention_pallas(
        jnp.asarray(q), jnp.repeat(jnp.asarray(kp), g, axis=2),
        jnp.repeat(jnp.asarray(vp), g, axis=2), jnp.asarray(tables),
        jnp.asarray(np.maximum(lens, 0)))
    np.testing.assert_allclose(_np(got), _np(plain), **F32)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert np.all(_np(got)[[i for i, n in enumerate(lengths) if n <= 0]]
                  == 0.0)


def test_split_walk_model_bad_entry_in_the_last_span_is_nan():
    """A walked entry outside the pool that only the last span reads makes
    the whole sequence NaN, as the plain version does; the others keep
    their values."""
    lengths = [2 * SPAN - 5, SPAN + 9, 40]
    q, kp, vp, tables, lens = _split_case(lengths, seed=3)
    bad = tables.copy()
    bad[0, (2 * SPAN - 6) // BLOCK] = 160              # last span only
    bad[1, SPAN // BLOCK + 1] = -1                     # its 2nd span
    args = [_t(a) for a in (q, kp, vp, bad, lens)]
    got = _split_walk_model(*args, span=SPAN)
    plain = paged_attention_plain(*args)
    assert torch.isnan(got[:2]).all() and torch.isnan(plain[:2]).all()
    base = _split_walk_model(*(_t(a) for a in (q, kp, vp, tables, lens)),
                             span=SPAN)
    assert torch.equal(got[2], base[2])
    np.testing.assert_allclose(_np(got[2]), _np(plain[2]), **F32)


def test_split_walk_model_never_reads_stale_entries():
    """Entries past ceil(length / block), even outside the pool, change
    nothing."""
    lengths = [SPAN + 1, 7, SPAN]
    q, kp, vp, tables, lens = _split_case(lengths, seed=5)
    stale = tables.copy()
    for b, n in enumerate(lengths):
        stale[b, -(-n // BLOCK):] = [10 ** 6, -9][b % 2]
    base = _split_walk_model(*(_t(a) for a in (q, kp, vp, tables, lens)),
                             span=SPAN)
    got = _split_walk_model(*(_t(a) for a in (q, kp, vp, stale, lens)),
                            span=SPAN)
    assert torch.equal(got, base)
    np.testing.assert_allclose(_np(got), _np(paged_attention_plain(
        *(_t(a) for a in (q, kp, vp, stale, lens)))), **F32)


@pytest.mark.parametrize("block,max_blocks", [
    (16, 256), (8, 4), (1, 3), (24, 10), (1000, 3), (64, 2), (16, 0),
    (48, 100)])
def test_split_plan_covers_every_position(block, max_blocks):
    """The wrapper's spans are whole blocks and whole chunks, about 512
    tokens, and cover [0, max_blocks·block) with no span left empty."""
    span, n_split = split_plan(block, max_blocks)
    assert span % block == 0 and span % CHUNK == 0
    assert span <= max(512, block * CHUNK // np.gcd(block, CHUNK))
    assert n_split * span >= max_blocks * block > (n_split - 1) * span \
        or max_blocks == n_split == 0
    assert split_plan(16, 256) == (512, 8)     # the smoke's pool


@pytest.mark.parametrize("lengths", [[5, 9, 17], [0, 9, 32], [32, 1, 0]])
def test_paged_attention_ref_matches_the_reference_oracle(lengths):
    """Including its uniform softmax at length 0."""
    q, kp, vp, tables, _ = _paged(seed=5)
    lengths = np.array(lengths, np.int32)
    want = jref.paged_attention_ref(*(jnp.asarray(a) for a in
                                      (q, kp, vp, tables, lengths)))
    got = ref.paged_attention_ref(*(_t(a) for a in
                                    (q, kp, vp, tables, lengths)))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ---------------------------------------------------------------------------
# the paged KV pool
# ---------------------------------------------------------------------------

def _state(al):
    return (list(al.free), {k: list(v) for k, v in al.tables.items()},
            dict(al.lengths), al.n_free, al.utilization())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_allocator_trace_matches_the_reference(seed):
    """A seeded admit / extend / release churn, run into exhaustion:
    identical tables, free lists, return values and MemoryError points."""
    rng = np.random.default_rng(seed)
    cfg = (48, 4, 6)
    jal = jkv.BlockAllocator(jkv.PoolConfig(*cfg))
    tal = tkv.BlockAllocator(tkv.PoolConfig(*cfg))
    live, next_id, outcomes = [], 0, set()
    for _ in range(300):
        op = rng.integers(0, 4)
        if op == 0 or not live:
            n = int(rng.integers(0, 30))
            res = []
            for al in (jal, tal):
                try:
                    res.append(("ok", al.admit(next_id, n)))
                except MemoryError:
                    res.append(("MemoryError", None))
            assert res[0] == res[1]
            assert jal.can_admit(n) == tal.can_admit(n)
            outcomes.add(res[0][0])
            if res[0][0] == "ok":
                live.append(next_id)
            next_id += 1
        elif op in (1, 2):
            sid = live[int(rng.integers(0, len(live)))]
            n = int(rng.integers(1, 9))
            r = (jal.extend(sid, n), tal.extend(sid, n))
            assert r[0] == r[1]
            outcomes.add(("extend", r[0]))
        else:
            sid = live.pop(int(rng.integers(0, len(live))))
            jal.release(sid)
            tal.release(sid)
        assert _state(jal) == _state(tal)
        for sid in live:
            a, b = jal.table_array(sid), tal.table_array(sid)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert {"MemoryError", ("extend", False)} <= outcomes
    assert np.array_equal(jal.table_array(10 ** 6), tal.table_array(10 ** 6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_write_and_gather_match_the_reference(dtype):
    """`init_pool` -> `write_token` -> `gather_kv` against the
    reference's, and `pool_from_numpy` of the reference's pool: the same
    bytes."""
    cfg = (8, 4, 3)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jpool = jkv.init_pool(jkv.PoolConfig(*cfg), 2, 16, 2, dtype=jd)
    tpool = tkv.init_pool(tkv.PoolConfig(*cfg), 2, 16, 2, dtype=td,
                          device="cpu")
    rng = np.random.default_rng(0)
    for layer, bids, offs in ((0, [3, 5, 0], [1, 0, 3]),
                              (1, [7, 3], [2, 2]), (0, [3], [1])):
        kn = rng.normal(size=(len(bids), 2, 16)).astype(np.float32)
        vn = rng.normal(size=(len(bids), 2, 16)).astype(np.float32)
        jpool = jkv.write_token(jpool, layer, jnp.asarray(bids),
                                jnp.asarray(offs), jnp.asarray(kn),
                                jnp.asarray(vn))
        out = tkv.write_token(tpool, layer, torch.tensor(bids),
                              torch.tensor(offs), _t(kn), _t(vn))
        assert out is tpool                      # updated in place
    tables = np.array([[3, 5, 0], [7, 0, 0]], np.int32)
    for layer in (0, 1):
        jk, jv = jkv.gather_kv(jpool, layer, jnp.asarray(tables))
        tk, tv = tkv.gather_kv(tpool, layer, _t(tables))
        assert tk.shape == jk.shape == (2, 12, 2, 16) and tk.dtype == td
        np.testing.assert_array_equal(_np(tk), _np(jk))
        np.testing.assert_array_equal(_np(tv), _np(jv))
    carried = tkv.pool_from_numpy({k: np.asarray(v) for k, v in
                                   jpool.items()}, device="cpu")
    for name in ("k", "v"):
        assert carried[name].dtype == td
        assert carried[name].shape == tuple(jpool[name].shape)
        assert torch.equal(carried[name], tpool[name])
