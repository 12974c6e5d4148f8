#!/usr/bin/env python3
"""Time variants of the batched SpMM kernels (`csrc/spmm_ell.cu`,
`csrc/spmm_csr_seg.cu`) against the committed ones on one card, at
`chip_smoke.py`'s main-path shapes, in turns.

    python3 tools/spmm_ab.py [--log2n 22] [--ks 4,16,64] [--reps 20]

Each variant is the committed source with a few lines replaced
(`VARIANTS`), built with the port's `nvcc` flags into
`build/dev/<library>-<variant>/` (one `nvcc` each, all started
together) and loaded with `ctypes` beside the committed library:

  spmm_ell      tile32   column tiles of up to 32 (committed: 16)
                unroll4  the slot loop unrolled by 4
                direct   no interleaved copy: gathers X[c, j] from the
                         (k, n) batch as it lies
  spmm_csr_seg  tile16   column tiles of up to 16 (committed: 8)
                direct   as for ELL

on the FD 2^log2n ELL plan's slab (plus-times) and the R-MAT 2^log2n HYB
plan's light slab and heavy stream (plus-times, a (k, n) base), for
each k of `--ks`.  Every variant's output must equal the committed
kernel's bit for bit.  CUDA-event times (`--reps` launches) in the order
committed, variants, variants reversed, committed; each time is the
mean of its two turns, and the interleaved copy (`X.t().contiguous()`,
which the committed wrappers make) is timed alone beside them.  Prints
the card's name and power limit first; exits nonzero without a card or
when a variant differs.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

_ELL_GATHER = ("      gather_tile<KC>(xt + (long long)__ldg(idx + p) * k + c0, kc, "
               "vec, xv);")
_SEG_GATHER = ("        gather_tile<KC>(xc + (long long)scol[kk] * k, kc, vec, "
               "xv);")

#: library -> variant -> [(committed text, replacement)]
VARIANTS = {
    "spmm_ell": {
        "tile32": [("constexpr int kMaxTile = 16;",
                    "constexpr int kMaxTile = 32;"),
                   ("    SPMM_ELL_CASE(16)\n",
                    "    SPMM_ELL_CASE(16)\n    SPMM_ELL_CASE(32)\n")],
        "unroll4": [("    for (int w = 0; w < width; ++w) {",
                     "#pragma unroll 4\n    for (int w = 0; w < width; ++w) {")],
        "direct": [(_ELL_GATHER,
                    "      { const int j = __ldg(idx + p);\n"
                    "#pragma unroll\n"
                    "        for (int c = 0; c < KC; ++c)\n"
                    "          xv[c] = c < kc ? __ldg(xt + (long long)(c0 + c)"
                    " * n_rows + j) : 0.0f; }")],
    },
    "spmm_csr_seg": {
        "tile16": [("constexpr int kMaxTile = 8;",
                    "constexpr int kMaxTile = 16;"),
                   ("      SPMM_SEG_CASE(8)\n",
                    "      SPMM_SEG_CASE(8)\n      SPMM_SEG_CASE(16)\n")],
        "direct": [(_SEG_GATHER,
                    "        { const int j = scol[kk];\n"
                    "#pragma unroll\n"
                    "          for (int c = 0; c < KC; ++c)\n"
                    "            xv[c] = c < kc ? __ldg(xt + (long long)(c0 + c)"
                    " * n_rows + j) : 0.0f; }")],
    },
}
#: the variants that read X as it lies, (k, n), instead of its copy
DIRECT = {"direct"}


def build_variants(_build) -> dict:
    """{(library, variant): ctypes library}, the committed ones as
    variant "committed"."""
    _build.build_all()
    libs, procs = {}, []
    dev_dir = ROOT / "build" / "dev"
    for lib, variants in VARIANTS.items():
        libs[(lib, "committed")] = ctypes.CDLL(str(_build.library_path(lib)))
        src = (_build.CSRC / f"{lib}.cu").read_text()
        for name, edits in variants.items():
            text = src
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"spmm_ab: {lib} {name}: the committed "
                                     f"source lacks {old!r}")
                text = text.replace(old, new)
            out = dev_dir / f"{lib}-{name}"
            out.mkdir(parents=True, exist_ok=True)
            for h in _build.CSRC.glob("*.cuh"):
                shutil.copy(h, out / h.name)
            (out / f"{lib}.cu").write_text(text)
            so = out / f"lib{lib}.so"
            cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                   str(out / f"{lib}.cu")]
            procs.append(((lib, name), so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for key, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"spmm_ab: nvcc failed for {key}:\n{out}")
        libs[key] = ctypes.CDLL(str(so))
    return libs


def entry(lib, fn_name, argtypes):
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def events_ms(call, reps: int) -> float:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(calls: dict, reps: int) -> dict:
    """{name: mean ms of two turns}, in the order given, then reversed."""
    names = list(calls)
    times = {n: [] for n in names}
    for n in names + names[::-1]:
        times[n].append(events_ms(calls[n], reps))
    return {n: sum(t) / len(t) for n, t in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log2n", type=int, default=22)
    ap.add_argument("--ks", default="4,16,64")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spmm_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.generators import fd_matrix, rmat_matrix
    from repro_torch.graph.semiring import PLUS_TIMES
    from repro_torch.kernels import _build
    from repro_torch.plan import compile as compile_plan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    libs = build_variants(_build)
    n = 1 << args.log2n
    opts = dict(reorder="none", predictor="none", device=dev)
    ell = compile_plan(fd_matrix(n, device=dev), format="ell", **opts).prep
    hyb = compile_plan(rmat_matrix(n, device=dev), format="hyb", **opts).prep
    stream = torch.cuda.current_stream().cuda_stream
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    failures = 0
    for k in (int(v) for v in args.ks.split(",")):
        gen = torch.Generator(device=dev).manual_seed(k)
        X = torch.rand((k, n), generator=gen, device=dev)
        xt = X.t().contiguous()
        base = torch.rand((k, n), generator=gen, device=dev)
        copy_ms = events_ms(lambda: X.t().contiguous(), args.reps)
        cases = [("fd ell", "spmm_ell", ell), ("rmat light", "spmm_ell",
                                                hyb.light),
                 ("rmat heavy", "spmm_csr_seg", hyb.heavy)]
        for label, lib, p in cases:
            outs, calls = {}, {}
            for name in ["committed", *VARIANTS[lib]]:
                src = X if name in DIRECT else xt
                Y = torch.empty((k, n), device=dev)
                outs[name] = Y
                if lib == "spmm_ell":
                    fn = entry(libs[(lib, name)], "spmm_ell_f32",
                               [P] * 4 + [I] * 4 + [P])
                    calls[name] = (lambda fn=fn, src=src, Y=Y: fn(
                        p.data.data_ptr(), p.idx.data_ptr(), src.data_ptr(),
                        Y.data_ptr(), n, p.data.shape[0], k,
                        PLUS_TIMES.code, stream))
                else:
                    n_win = p.win_row.shape[0] - 1
                    carries = torch.empty((2, k, n_win), device=dev)
                    fn = entry(libs[(lib, name)], "spmm_csr_seg_f32",
                               [P] * 9 + [L] + [I] * 6 + [P])
                    calls[name] = (lambda fn=fn, src=src, Y=Y, c=carries: fn(
                        p.vals.data_ptr(), p.cols.data_ptr(),
                        p.row_ptr.data_ptr(), p.win_row.data_ptr(),
                        p.split_rows.data_ptr(), src.data_ptr(),
                        base.data_ptr(), c.data_ptr(), Y.data_ptr(),
                        p.vals.shape[0], n, n_win, p.split_rows.shape[0],
                        p.window, k, PLUS_TIMES.code, stream))
            for name, call in calls.items():
                rc = call()
                if rc != 0:
                    raise SystemExit(f"spmm_ab: {lib} {name} launch failed "
                                     f"({rc})")
            torch.cuda.synchronize()
            ms = in_turns(calls, args.reps)
            ref = outs["committed"].view(torch.int32)
            line = []
            for name, t in ms.items():
                same = torch.equal(outs[name].view(torch.int32), ref)
                failures += not same
                line.append(f"{name}={t:.4f}" + (
                    "" if name == "committed" else
                    f" ({t / ms['committed']:.3f}x, bit-equal {same})"))
            print(f"ab {lib} [{label}] k={k}: " + " ".join(line)
                  + f"; interleave copy alone {copy_ms:.4f} ms", flush=True)
        del X, xt, base
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
