"""Per-op costs of a step traced once: the counterpart of
`repro.roofline.hlo_costs`.

The reference compiles a step and reads the optimized HLO's ops.  The
port has no compiler to ask, so it runs the step once under a
`CostCounter` (a `TorchDispatchMode`) and prices every aten op that the
step dispatches, with the reference's conventions:

  matmul class   2·M·N·K, exact, from `torch.utils.flop_counter`'s
                 formulas (mm, addmm, bmm, baddbmm, convolutions, SDPA);
                 also tallied apart as `matmul_flops`
  elementwise    1 flop per output element (ops tagged pointwise)
  transcendental 1 flop per output element, also tallied apart (exp,
                 log, sqrt, rsqrt, tanh, sigmoid, sin, cos, erf, ...)
  reductions     max(input elements, output elements) flops; a softmax
                 5 flops an element, one of them transcendental (its
                 unfused max, subtract, exp, sum and divide)
  views          free: every op whose schema says it aliases its input,
                 and the ops that only relabel or allocate
  bytes          operands plus results of every op that moves data; a
                 copy into a slice moves the slice twice, a gather its
                 result twice plus the indices, a scatter its update
                 twice plus the indices (`hlo_costs._op_local_costs`)

Eager PyTorch fuses nothing, so `bytes` is an upper bound on HBM
traffic, as the reference's CPU-HLO bytes are.  An eager trace unrolls
every loop, so there are no trip counts to fold and
`unknown_trip_counts` stays 0; the HLO text parser has no counterpart.

Collectives: the port's `distributed.api` collectives report their kind
and wire bytes to the counter (`observe_collectives`), with the
reference's ring factors (all-reduce 2x operand bytes, all-gather 1x
result, reduce-scatter and all-to-all 1x operand, collective-permute
1x result); the dispatched c10d ops themselves are free.

Given tensors to `watch` (a step's inputs), the counter also notes which
of them a priced op took as an operand, through any view of them
(`touches`): the inputs the step reads whole, for a floor on its bytes
(`launch.steps.LoweredPlan.floor_bytes`).  A gather's source is not
one: the gather reads its rows, not the table.

Each op is charged to its call site: the innermost frame of
`repro_torch` that called it (`models/common.py:apply_attention:353`),
or, for an op autograd runs, `backward:<node>`.  Rows group the calls
of one op at one site; `top_ops` ranks them as the reference's does.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.dirname(os.path.abspath(__file__))
_AUTOGRAD = os.path.join("torch", "autograd", "")
_TORCH = os.path.dirname(torch.__file__)

#: ops that move no data: relabelings, allocations without a write,
#: host reads and bookkeeping
_FREE = {
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "_unsafe_view",
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "set_", "resize_", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_has_compatible_shallow_copy_type", "record_stream",
    "_record_function_enter_new", "_record_function_exit",
}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt",
    "rsqrt", "tanh", "sigmoid", "sin", "cos", "tan", "erf", "erfc",
    "erfinv", "atan", "asin", "acos", "sinh", "cosh", "logit",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin",
    "prod", "norm", "linalg_vector_norm", "var", "std", "var_mean",
    "std_mean", "any", "all", "logsumexp", "cumsum", "cumprod",
    "nansum", "count_nonzero", "aminmax", "sort", "topk", "searchsorted",
}
_SOFTMAX = {"_softmax", "_log_softmax", "softmax", "log_softmax"}
_GATHERS = {"embedding", "index", "index_select", "gather"}
# op -> (position of its update operand, of its index operand)
_SCATTERS = {"index_put": (2, 1), "index_put_": (2, 1),
             "_index_put_impl_": (2, 1), "scatter": (3, 2),
             "scatter_": (3, 2), "scatter_add": (3, 2),
             "scatter_add_": (3, 2), "scatter_reduce": (3, 2),
             "scatter_reduce_": (3, 2), "index_add": (3, 2),
             "index_add_": (3, 2), "index_copy": (3, 2),
             "index_copy_": (3, 2)}
_FILLS = {"fill_", "zero_", "zeros", "ones", "full", "zeros_like",
          "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
          "arange", "scalar_tensor", "rand", "randn", "normal_",
          "uniform_", "bernoulli_", "randint", "randperm"}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    transcendental: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    unknown_trip_counts: int = 0
    matmul_flops: float = 0.0

    def scaled(self, k: float) -> "Costs":
        return Costs(
            flops=self.flops * k,
            transcendental=self.transcendental * k,
            bytes=self.bytes * k,
            collective_bytes={o: b * k for o, b in
                              self.collective_bytes.items()},
            collective_counts={o: c * k for o, c in
                               self.collective_counts.items()},
            unknown_trip_counts=self.unknown_trip_counts,
            matmul_flops=self.matmul_flops * k,
        )

    def add(self, other: "Costs") -> None:
        self.flops += other.flops
        self.transcendental += other.transcendental
        self.bytes += other.bytes
        for o, b in other.collective_bytes.items():
            self.collective_bytes[o] = self.collective_bytes.get(o, 0.0) + b
        for o, c in other.collective_counts.items():
            self.collective_counts[o] = (
                self.collective_counts.get(o, 0.0) + c)
        self.unknown_trip_counts += other.unknown_trip_counts
        self.matmul_flops += other.matmul_flops

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    """The identity of `t`'s storage, which its views share."""
    return t.untyped_storage()._cdata


_KINDS: Dict[object, str] = {}


def _kind(func) -> str:
    """How an op is priced (cached by overload)."""
    kind = _KINDS.get(func)
    if kind is not None:
        return kind
    name = func.__name__.split(".")[0]
    ns = func.namespace
    from torch.utils.flop_counter import flop_registry
    if ns not in ("aten", "prims"):
        kind = "free"               # c10d, profiler and custom ops
    elif func.overloadpacket in flop_registry:
        kind = "matmul"
    elif func.is_view or name in _FREE:
        kind = "free"
    elif name in _SOFTMAX:
        kind = "softmax"
    elif name in _GATHERS:
        kind = "gather"
    elif name in _SCATTERS:
        kind = "scatter"
    elif name in ("copy_", "copy"):
        kind = "copy"
    elif name in _FILLS:
        kind = "fill"
    elif name.rstrip("_") in _TRANSCENDENTAL:
        kind = "transcendental"
    elif torch.Tag.pointwise in func.tags:
        kind = "pointwise"
    elif name in _REDUCTIONS:
        kind = "reduce"
    elif "backward" in name:
        kind = "pointwise"          # 1 flop an output element
    else:
        kind = "move"               # bytes only (cat, clone, _to_copy)
    _KINDS[func] = kind
    return kind


def op_cost(func, args, kwargs, out) -> Optional[tuple]:
    """(flops, matmul_flops, transcendental, bytes) of one dispatched
    op, or None for a free one."""
    kind = _kind(func)
    if kind == "free":
        return None
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    out_elems = sum(t.numel() for t in outs)
    out_bytes = sum(_nbytes(t) for t in outs)
    in_bytes = sum(_nbytes(t) for t in ins)
    if kind == "matmul":
        from torch.utils.flop_counter import flop_registry
        f = int(flop_registry[func.overloadpacket](*args, **(kwargs or {}),
                                                   out_val=out))
        return f, f, 0, in_bytes + out_bytes
    if kind == "gather":
        idx = sum(_nbytes(t) for t in ins[1:])
        return 0, 0, 0, 2 * out_bytes + idx
    if kind == "scatter":
        upd_at, idx_at = _SCATTERS[func.__name__.split(".")[0]]
        flat = tree_flatten(args)[0]
        upd = flat[upd_at] if len(flat) > upd_at else None
        upd_b = _nbytes(upd) if isinstance(upd, torch.Tensor) else out_bytes
        idx = flat[idx_at] if len(flat) > idx_at else None
        idx_b = sum(_nbytes(t) for t in _tensors(idx))
        adds = upd.numel() if "add" in func.__name__ and \
            isinstance(upd, torch.Tensor) else 0
        return adds, 0, 0, 2 * upd_b + idx_b
    if kind == "copy":
        src = ins[1] if len(ins) > 1 else ins[0]
        return 0, 0, 0, min(_nbytes(src), out_bytes) + out_bytes
    if kind == "fill":
        return 0, 0, 0, out_bytes
    if kind == "softmax":
        return 5 * out_elems, 0, out_elems, in_bytes + out_bytes
    if kind == "transcendental":
        return out_elems, 0, out_elems, in_bytes + out_bytes
    if kind == "pointwise":
        return max(out_elems, 1), 0, 0, in_bytes + out_bytes
    if kind == "reduce":
        n_in = ins[0].numel() if ins else 0
        return max(n_in, out_elems), 0, 0, in_bytes + out_bytes
    return 0, 0, 0, in_bytes + out_bytes


def call_site() -> str:
    """The innermost `repro_torch` frame outside this package that led
    here, as `dir/file.py:function:line` (or, for a caller outside the
    package, its innermost frame outside torch, by file name);
    `backward:<node>` for an op of the backward pass itself (autograd's
    engine is met first; an op a recompute runs keeps its model frame);
    "" otherwise."""
    f = sys._getframe(2)
    outside = None
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_PKG) and not path.startswith(_SELF):
            rel = os.path.relpath(path, _PKG)
            return f"{rel}:{f.f_code.co_name}:{f.f_lineno}"
        if _AUTOGRAD in path:
            break
        if outside is None and not path.startswith((_TORCH, _SELF)):
            outside = (f"{os.path.basename(path)}:{f.f_code.co_name}:"
                       f"{f.f_lineno}")
        f = f.f_back
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"backward:{node.name()}"
    return outside or ""


#: row fields, in the order `rows()` writes them
ROW_FIELDS = ("op", "site", "calls", "flops", "matmul_flops",
              "transcendental", "bytes", "collective", "wire_bytes")


class CostCounter(TorchDispatchMode):
    """Prices every op dispatched while it is active, and every
    collective of `distributed.api` (see the module docstring).

        with CostCounter(watch=leaves(inputs)) as cc:
            step(*inputs)
        cc.costs(); cc.top_ops(by="flops"); cc.touches(inputs[0])
    """

    def __init__(self, watch=()):
        super().__init__()
        self._rows: Dict[tuple, list] = {}
        self._observe = None
        self._watch = {_storage(t) for t in watch}
        self._touched: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        cost = op_cost(func, args, kwargs, out)
        if cost is not None:
            key = (str(func), call_site(), None)
            row = self._rows.setdefault(key, [0, 0, 0, 0, 0, 0])
            row[0] += 1
            for i, v in enumerate(cost):
                row[1 + i] += v
            if self._watch:
                ins = _tensors((args, kwargs))
                if _kind(func) == "gather":
                    ins = ins[1:]       # the rows it reads, not its table
                self._touched.update(k for k in map(_storage, ins)
                                     if k in self._watch)
        return out

    def touches(self, t: torch.Tensor) -> bool:
        """Whether a priced op took `t` (a watched tensor) or a view of
        it as an operand."""
        return _storage(t) in self._touched

    def collective(self, kind: str, wire_bytes: int) -> None:
        """One collective of `kind` ("all-reduce", ...) that put
        `wire_bytes` on the wire by the ring factors."""
        key = (kind, call_site(), kind)
        row = self._rows.setdefault(key, [0, 0, 0, 0, 0, 0])
        row[0] += 1
        row[5] += int(wire_bytes)

    def __enter__(self):
        from repro_torch.distributed import api
        self._observe = api.observe_collectives(self.collective)
        self._observe.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._observe.__exit__(*exc)

    def rows(self) -> List[dict]:
        """The rows as dicts of `ROW_FIELDS` (JSON-ready), costliest
        bytes first."""
        out = [dict(zip(ROW_FIELDS, (op, site, *v[:5], coll, v[5])))
               for (op, site, coll), v in self._rows.items()]
        out.sort(key=lambda r: (-r["bytes"], -r["flops"], r["op"],
                                r["site"]))
        return out

    def costs(self) -> Costs:
        return costs_of_rows(self.rows())

    def top_ops(self, by: str = "bytes", k: int = 20):
        return top_ops(self.rows(), by, k)


def costs_of_rows(rows: List[dict]) -> Costs:
    """The step's totals from its rows (a saved trace re-derives them)."""
    c = Costs(flops=0, transcendental=0, bytes=0, matmul_flops=0)
    for r in rows:
        c.flops += r["flops"]
        c.matmul_flops += r["matmul_flops"]
        c.transcendental += r["transcendental"]
        c.bytes += r["bytes"]
        if r["collective"]:
            kind = r["collective"]
            c.collective_bytes[kind] = (c.collective_bytes.get(kind, 0)
                                        + r["wire_bytes"])
            c.collective_counts[kind] = (c.collective_counts.get(kind, 0)
                                         + r["calls"])
    return c


def top_ops(rows: List[dict], by: str = "bytes", k: int = 20):
    """Top-k rows by `by` ("bytes", "flops", "matmul_flops" or
    "wire_bytes"): (value, op, name, multiplier, tag) as
    `hlo_costs.top_ops` gives them -- the short op name, the overload,
    the calls the row groups, and the call site."""
    out = []
    for r in rows:
        val = r[by]
        if val <= 0:
            continue
        short = r["op"].split(".")[1] if r["op"].startswith("aten.") \
            else r["op"]
        out.append((val, short, r["op"], r["calls"], r["site"]))
    out.sort(key=lambda t: (-t[0], t[1], t[4]))
    return out[:k]
