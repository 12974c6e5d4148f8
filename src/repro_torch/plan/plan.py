"""`SpmvPlan` -- the frozen decision chain for one matrix.

Counterpart of `repro.plan.plan`.  A plan holds the structure report,
the reordering, the chosen format, the converted container and the
prepared kernel layout, all on the plan's device.  `execute` is the hot
path: it does no analysis, conversion or padding -- only the x gather
and y scatter of a reordered plan (`index_select` over index tensors
uploaded once) around the kernel wrapper of the plan's format, which
launches the CUDA kernel on a CUDA plan and runs the plain version on a
CPU plan.

  * `execute(x)`       one multiply through the prepared layout, in the
                       original row/column order (`use_pallas=False`
                       plans run the container's plain PyTorch oracle
                       instead; the option keeps the reference's name so
                       cache keys agree);
  * `execute_many(X)`  batched multi-vector SpMV (SpMM): on an 'ell',
                       'hyb' or 'csr-seg' kernel plan one launch of each
                       batched kernel (`spmm_ell`, `spmm_csr_seg`)
                       whatever k is, on the other kernel plans one
                       `execute` per row of X -- either way each row
                       equals `execute` bit for bit; the container's
                       plain oracle over the whole batch on a
                       `use_pallas=False` plan;
  * `power_iteration`  repeated `execute` with normalisation;
  * `address_trace(machine)`  the SpMV demand-address trace of the
                       planned (permuted) matrix on a simulated CPU
                       (`telemetry.hierarchy.format_address_trace`),
                       built on the host and cached per machine.

A row-sharded plan ('ell-sharded', `compile(mesh=...)`) holds no
container: its `prep` is a `kernels._layout.ShardedELL` and `mesh` the
`distributed.RowMesh` its slabs run on (never serialized; `load_plan`
takes `mesh=` to rebind one).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.core.formats import BELL, CSR, DIA, ELL, HYB
from repro_torch.graph.semiring import resolve
from repro_torch.kernels import _layout as kl
from repro_torch.kernels.spmv_bell import spmv_bell_torch
from repro_torch.kernels.spmv_csr import spmv_csr_torch
from repro_torch.kernels.spmv_csr_seg import spmv_hyb_torch
from repro_torch.kernels.spmv_dia import spmv_dia_plain
from repro_torch.kernels.spmv_ell import spmv_ell_torch

_RUNNERS = {"dia": kl.spmv_dia_prepared, "bell": kl.spmv_bell_prepared,
            "ell": kl.spmv_ell_prepared,
            "csr": kl.spmv_csr_prepared, "csr-seg": kl.spmv_csr_seg_prepared,
            "hyb": kl.spmv_hyb_prepared}
#: the formats whose batched kernels serve `execute_many`
_BATCHED = {"ell": kl.spmm_ell_prepared, "csr-seg": kl.spmm_csr_seg_prepared,
            "hyb": kl.spmm_hyb_prepared}


def container_spmv(container, x: torch.Tensor, sr) -> torch.Tensor:
    """The plain PyTorch oracle of a container; `x` (n,) or (k, n)."""
    if isinstance(container, DIA):
        if sr.name != "plus_times":
            raise ValueError("DIA is plus-times only")
        return spmv_dia_plain(container.data, container.offsets, x,
                              container.n_cols)
    if isinstance(container, BELL):
        if sr.name != "plus_times":
            raise ValueError("BELL is plus-times only")
        return spmv_bell_torch(container, x)
    if isinstance(container, HYB):
        return spmv_hyb_torch(container, x, sr)
    if isinstance(container, ELL):
        return spmv_ell_torch(container, x, sr)
    if isinstance(container, CSR):
        return spmv_csr_torch(container, x, sr)
    raise TypeError(f"unsupported container {type(container).__name__}")


@dataclasses.dataclass
class SpmvPlan:
    """Compiled, reusable execution plan for one matrix (obtain it from
    `repro_torch.plan.compile` or a `PlanCache`)."""

    fingerprint: str                 # digest of the ORIGINAL matrix
    format_name: str                 # 'dia'|'bell'|'ell'|'csr'|'csr-seg'|
                                     # 'hyb'|'ell-sharded'
    container: Any                   # converted container (post-reorder)
    prep: Any                        # prepared kernel layout (or None)
    device: torch.device
    reordering: Any = None           # repro_torch.reorder.Reordering
    report: Any = None               # StructureReport of the permuted
                                     # matrix (None if forced)
    csr: Any = None                  # post-reorder CSR, when kept
    threads: int = 1
    use_pallas: bool = True          # False: container oracle, no kernels
    semiring: str = "plus_times"
    predicted: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    chosen: str = "none"             # scored candidate ("none": unscored)
    compile_stats: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh: Any = None                 # sharded plans only; never serialized
    # machine -> address trace, filled by `address_trace`
    _traces: Dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def n_rows(self) -> int:
        src = self.container if self.container is not None else self.prep
        return int(src.n_rows)

    @property
    def n_cols(self) -> int:
        src = self.container if self.container is not None else self.prep
        return int(src.n_cols)

    def _input(self, x) -> torch.Tensor:
        """x on the plan's device as f32; a tensor on another device is
        refused rather than silently moved."""
        if isinstance(x, torch.Tensor) and x.device != self.device:
            raise ValueError(f"x lies on {x.device}, the plan on "
                             f"{self.device}")
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def execute(self, x) -> torch.Tensor:
        """y = A (⊕,⊗) x through the frozen plan (original order)."""
        x = self._input(x)
        if self.reordering is not None:
            y = self._run(self.reordering.permute_x(x))
            return self.reordering.restore_y(y)
        return self._run(x)

    __call__ = execute

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        sr = resolve(self.semiring)
        if self.format_name == "ell-sharded":
            from repro_torch.distributed.spmv import spmv_row_sharded_prepared

            if sr.name != "plus_times":
                raise ValueError("sharded plans are plus-times only")
            if self.mesh is None:
                raise ValueError("sharded plan has no mesh bound; pass "
                                 "mesh= to load_plan or set plan.mesh")
            return spmv_row_sharded_prepared(self.prep, x, self.mesh)
        if not self.use_pallas:
            if x.dim() != 1 or x.shape[0] != self.n_cols:
                raise ValueError(f"x must have shape ({self.n_cols},)")
            return container_spmv(self.container, x, sr)
        return _RUNNERS[self.format_name](self.prep, x, semiring=sr)

    def execute_many(self, X) -> torch.Tensor:
        """Batched SpMV: Y[k] = A (⊕,⊗) X[k] for a (k, n_cols) batch, in
        the original order; the whole batch is gathered through
        `col_perm` and scattered through `inv_row_perm` at once.  An
        'ell', 'hyb' or 'csr-seg' kernel plan runs its batched kernels
        once (the reference's one fused SpMM), every other kernel plan
        `execute` once per row of X, in order; either way Y[k] equals
        `execute(X[k])` bit for bit.  A `use_pallas=False` plan runs the
        container's oracle over the whole batch, whose sums are ordered
        too."""
        X = self._input(X)
        if X.dim() != 2 or X.shape[1] != self.n_cols:
            raise ValueError(f"execute_many expects (k, {self.n_cols}), "
                             f"got {tuple(X.shape)}")
        sr = resolve(self.semiring)
        if self.use_pallas:
            X = X.contiguous()
            if X.shape[0] == 0:
                return X.new_empty((0, self.n_rows))
            batched = _BATCHED.get(self.format_name)
            if batched is None:
                return torch.stack([self.execute(x) for x in X])

            def run(Xp):
                return batched(self.prep, Xp, semiring=sr)
        else:
            def run(Xp):
                return container_spmv(self.container, Xp, sr)
        if self.reordering is None:
            return run(X)
        return self.reordering.restore_y(run(self.reordering.permute_x(X)))

    def power_iteration(self, x0, n_iters: int = 16):
        """Dominant-eigenpair estimate by repeated `execute`.  Returns
        (eigenvalue estimate, vector)."""
        x = self._input(x0)
        lam = torch.zeros((), dtype=x.dtype, device=x.device)
        for _ in range(n_iters):
            y = self.execute(x)
            lam = torch.linalg.vector_norm(y)
            x = y / torch.clamp(lam, min=1e-30)
        return lam, x

    def address_trace(self, machine):
        """The SpMV demand-address trace (int64 line ids) of the planned
        (permuted) matrix as `machine`'s cores issue it, per the plan's
        format: a 'hyb' plan's trace is the light row-major stream then
        the container's column-sorted heavy stream, every other format
        the flat CSR stream.  Built on the host (a card plan's arrays
        are copied once) and cached per machine."""
        if self.csr is None:
            raise ValueError("plan was compiled with keep_csr=False; "
                             "no CSR retained for trace replay")
        if machine not in self._traces:
            from repro_torch.telemetry.hierarchy import format_address_trace

            self._traces[machine] = format_address_trace(
                self.csr, self.format_name, machine,
                container=self.container)
        return self._traces[machine]

    def summary(self) -> str:
        r = self.reordering.strategy if self.reordering is not None \
            else "none"
        gf = self.predicted.get(self.chosen, {}).get("gflops")
        gf_s = f" pred={gf:.2f}GF" if gf is not None else ""
        sr_s = "" if self.semiring == "plus_times" else f" sr={self.semiring}"
        return (f"SpmvPlan[{self.fingerprint[:8]}] fmt={self.format_name}"
                f"{sr_s} reorder={r} threads={self.threads}{gf_s}")


__all__ = ["SpmvPlan", "container_spmv"]
