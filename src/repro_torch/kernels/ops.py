"""Per-call wrappers: prepare the layout, run it, in one call.

Counterpart of `repro.kernels.ops`.  Each wrapper is
`prepare_*` + `spmv_*_prepared` from `_layout`: CUDA containers launch
the format's kernel, CPU containers run its plain version.  Repeated
multiplies of one matrix should compile a `repro_torch.plan.SpmvPlan`
(or call `core.spmv.spmv`, which caches one) instead of re-preparing.

Every wrapper takes `reordering=`: the matrix is then the REORDERED
operand while x and y stay in the original order (x is gathered through
`col_perm` before the multiply, y scattered back through `inv_row_perm`
after).  The attention wrappers take (batch, heads, seq, head_dim)
tensors and launch the flash and paged attention kernels on CUDA
tensors.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.formats import BELL, CSR, DIA, ELL, HYB
from repro_torch.graph.semiring import resolve

from .flash_attention import flash_attention as _flash_attention
from .paged_attention import paged_attention as _paged_attention
from .spmv_csr_seg import WINDOW
from ._layout import (prepare_bell, prepare_csr, prepare_csr_seg,
                      prepare_dia, prepare_ell, prepare_hyb,
                      spmv_bell_prepared, spmv_csr_prepared,
                      spmv_csr_seg_prepared, spmv_dia_prepared,
                      spmv_ell_prepared, spmv_hyb_prepared)


def _reordered(kernel_fn):
    """Give a `fn(matrix, x, ..)` wrapper an optional `reordering`
    keyword: gather x through col_perm in, scatter y through
    inv_row_perm out."""
    @functools.wraps(kernel_fn)
    def run(matrix, x, *args, reordering=None, **kwargs):
        if reordering is None:
            return kernel_fn(matrix, x, *args, **kwargs)
        y = kernel_fn(matrix, reordering.permute_x(x), *args, **kwargs)
        return reordering.restore_y(y)
    return run


def _refuse_zero_col0_slots(data: torch.Tensor, idx: torch.Tensor,
                            what: str, build: str, semiring) -> None:
    """A slot holding (value 0.0, col 0) reads as a real weight-0 edge to
    vertex 0 under a semiring whose absorbing element is not 0.0 (the
    check is conservative: a genuine explicit zero in column 0 trips it
    too)."""
    if data.numel() and bool(((data == 0.0) & (idx == 0)).any()):
        raise ValueError(
            f"{what} has (value 0.0, col 0) slots, which the "
            f"{semiring.name!r} semiring (pad_value="
            f"{semiring.pad_value!r}) would treat as real edges; build it "
            f"with {build} so padding is absorbing")


@_reordered
def spmv_dia(dia: DIA, x: torch.Tensor) -> torch.Tensor:
    return spmv_dia_prepared(prepare_dia(dia), x)


@_reordered
def spmv_bell(bell: BELL, x: torch.Tensor) -> torch.Tensor:
    return spmv_bell_prepared(prepare_bell(bell), x)


@_reordered
def spmv_ell(ell: ELL, x: torch.Tensor, semiring=None) -> torch.Tensor:
    """Non-plus-times semirings need the container's short-row padding
    to be absorbing: build it with `ELL.from_csr(csr,
    fill=semiring.pad_value)`."""
    sr = resolve(semiring)
    if sr.pad_value != 0.0:
        _refuse_zero_col0_slots(
            ell.data, ell.indices, "ELL container",
            "ELL.from_csr(csr, fill=semiring.pad_value)", sr)
    return spmv_ell_prepared(prepare_ell(ell, sr), x, sr)


@_reordered
def spmv_csr(csr: CSR, x: torch.Tensor, n_stripes: int = 1,
             semiring=None) -> torch.Tensor:
    sr = resolve(semiring)
    return spmv_csr_prepared(
        prepare_csr(csr, n_stripes=n_stripes, semiring=sr), x, sr)


@_reordered
def spmv_csr_seg(csr: CSR, x: torch.Tensor, seg_len: int = WINDOW,
                 semiring=None) -> torch.Tensor:
    """Merge-path segmented CSR: windows of `seg_len` row ends and
    nonzeros."""
    sr = resolve(semiring)
    return spmv_csr_seg_prepared(prepare_csr_seg(csr, seg_len=seg_len), x,
                                 sr)


@_reordered
def spmv_hyb(hyb: HYB, x: torch.Tensor, seg_len: int = WINDOW,
             semiring=None) -> torch.Tensor:
    """Hybrid row split: the ELL kernel over the light rows, the
    segmented kernel over the heavy stream, joined by ⊕.  Non-plus-times
    semirings need absorbing light padding: build the container with
    `HYB.from_csr(csr, fill=semiring.pad_value)`."""
    sr = resolve(semiring)
    if sr.pad_value != 0.0:
        _refuse_zero_col0_slots(
            hyb.data, hyb.indices, "HYB light partition",
            "HYB.from_csr(csr, fill=semiring.pad_value)", sr)
    return spmv_hyb_prepared(prepare_hyb(hyb, seg_len=seg_len, semiring=sr),
                             x, sr)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, H, hd); pools: (n_blocks, block, KVH, hd) with KVH | H;
    tables: (B, max_blocks); lengths: (B,) -> (B, H, hd).  The kernel
    maps query head h to KV head h // (H // KVH), the order of the
    reference's `jnp.repeat`, without materialising the repeat."""
    return _paged_attention(q, k_pool, v_pool,
                               tables.to(torch.int32).contiguous(),
                               lengths.to(torch.int32).contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q/k/v: (batch, heads, seq, head_dim); GQA callers broadcast kv
    first (`repeat_interleave` over heads)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    of = _flash_attention(q.reshape(b * h, sq, d), k.reshape(b * h, skv, d),
                          v.reshape(b * h, skv, d), causal=causal,
                          window=window)
    return of.reshape(b, h, sq, d)


__all__ = ["spmv_dia", "spmv_bell", "spmv_ell", "spmv_csr", "spmv_csr_seg",
           "spmv_hyb", "paged_attention", "flash_attention"]
