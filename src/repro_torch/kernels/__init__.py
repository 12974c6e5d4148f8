"""The port's nine kernels -- five SpMV formats, the batched (SpMM) ELL
and segmented CSR of `execute_many`, flash attention and paged
attention -- hand-written CUDA for Hopper (`csrc/`), each with a ctypes
wrapper that counts its launches, a plain PyTorch version beside it, and
the plan-time layouts in `_layout`."""
from .flash_attention import flash_attention, flash_attention_plain
from .paged_attention import paged_attention, paged_attention_plain
from .spmv_bell import spmv_bell, spmv_bell_plain, spmv_bell_torch
from .spmv_csr import spmv_csr, spmv_csr_plain, spmv_csr_torch
from .spmv_csr_seg import (spmm_csr_seg, spmv_csr_seg, spmv_csr_seg_plain,
                           spmv_hyb_torch)
from .spmv_dia import spmv_dia, spmv_dia_plain
from .spmv_ell import (interleave_columns, spmm_ell, spmv_ell,
                       spmv_ell_plain, spmv_ell_torch)

#: kernel name -> wrapper (each wrapper carries its `launches` count)
KERNELS = {"spmv_dia": spmv_dia, "spmv_ell": spmv_ell,
           "spmv_csr": spmv_csr, "spmv_csr_seg": spmv_csr_seg,
           "spmv_bell": spmv_bell, "spmm_ell": spmm_ell,
           "spmm_csr_seg": spmm_csr_seg, "flash_attention": flash_attention,
           "paged_attention": paged_attention}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["KERNELS", "reset_launch_counts", "launch_counts",
           "spmv_dia", "spmv_dia_plain", "spmv_ell", "spmv_ell_plain",
           "spmv_ell_torch", "spmv_csr", "spmv_csr_plain", "spmv_csr_torch",
           "spmv_csr_seg", "spmv_csr_seg_plain", "spmv_hyb_torch",
           "spmv_bell", "spmv_bell_plain", "spmv_bell_torch",
           "spmm_ell", "spmm_csr_seg", "interleave_columns",
           "flash_attention", "flash_attention_plain", "paged_attention",
           "paged_attention_plain"]
