#!/usr/bin/env python3
"""Time the batched SpMM kernels (`csrc/spmm_ell.cu`, `csrc/spmm_csr_seg.cu`)
against the previous design and against variants of their own choices on
one card, at `chip_smoke.py`'s main-path shapes, in turns.

    python3 tools/spmm_ab.py --fetch-baseline REV     # where git is
    python3 tools/spmm_ab.py [--log2n 22] [--ks 4,16,64] [--reps 20]

`--fetch-baseline REV` writes the batched kernels' sources of commit REV
(`spmm_ell.cu`, `spmm_csr_seg.cu` and the headers) into
`build/dev/baseline/` and exits; copy `build/` with the tree to the
machine that holds the card.  The timing run builds them as the
"baseline" libraries (the design before whole-row gathers and the
direct read: one thread a row or a virtual thread, 16- and 8-column
tiles, X always through its interleaved copy).  The committed Xt ELL
kernel is that design's, so there the two should agree.  Where that
directory is missing and the tree has no git history, the baseline is
the previous design's times as `PERF.md` records them (§6, the batched
table), and the run says so.

Variants are the committed sources with a few lines replaced, built
into `build/dev/<library>-<variant>/` (one `nvcc` each, all started
together) and loaded with `ctypes` beside the committed library:

  spmm_ell      tile2/8/16  the direct kernel's columns a tile
                          (committed 4)
                xttile8   the Xt kernel's columns a tile (committed 16)
  spmm_csr_seg  depth2/4/8  gathers a lane issues before folding, at
                          every group width (committed: 4 at G >= 8, 2
                          below)
                group8    groups up to 8 lanes: two passes over the
                          window at k = 64 (committed 16)
                cpasync8/12  the gathers staged in shared memory by
                          cp.async, 8 or 12 a lane (one CTA an SM)
                ldcg      the gathers cached in L2 only
                streamio  base loads and Y stores as streaming accesses
                onecta    one CTA an SM, gather depth 8 (4 below G = 8)

and the committed ELL kernel is also called with the other gather layout
(direct on the R-MAT light slab, xt on FD's).  Cases: the FD 2^log2n ELL
plan's slab, the R-MAT 2^log2n HYB plan's light slab and heavy stream
(with a (k, n) base), plus-times, for each k of `--ks`.  Every output must
equal the committed kernel's bit for bit.  CUDA-event times (`--reps`
launches) in the order committed, others, others reversed, committed;
each time is the mean of its two turns; the interleaved copy
(`X.t().contiguous()`) is timed alone beside them, and a line says what
each ELL call costs with the copy it needs.  Prints the card's name and
power limit first; exits nonzero without a card or when an output
differs.
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
DEV_DIR = ROOT / "build" / "dev"
BASELINE_DIR = DEV_DIR / "baseline"
KERNEL_FILES = ("spmm_ell.cu", "spmm_csr_seg.cu", "tile.cuh", "common.cuh",
                "semiring.cuh")
#: the previous design's kernel times, ms, at k = 4 / 16 / 64 (PERF.md §6,
#: the batched table's previous-design column: NVIDIA H100 80GB HBM3,
#: 700.00 W), for a tree with neither baseline sources nor git history
RECORDED_BASELINE = {"fd ell": (0.1563, 0.4021, 2.4911),
                     "rmat light": (0.0632, 0.1659, 0.6052),
                     "rmat heavy": (0.6618, 1.8159, 8.7092),
                     "copy": (0.0634, 0.2256, 1.6142)}
RECORDED_KS = (4, 16, 64)

_SEG_BATCH = """        while (kk < kend) {
          const int nb = min(kDepth<G>, kend - kk);
          float4 xv[kDepth<G>];
#pragma unroll
          for (int j = 0; j < kDepth<G>; ++j)
            if (j < nb)
              xv[j] = gather_quad(xc + (long long)scol[kk + j] * k, 4 * l,
                                  kc, vec);
#pragma unroll
          for (int j = 0; j < kDepth<G>; ++j)
            if (j < nb) {
              close_rows();
              s = fold4<SR>(s, sval[kk], xv[j]);
              ++kk;
            }
        }
"""
_SEG_CPASYNC = """        while (kk < kend) {
          const int nb = min(kRing, kend - kk);
          for (int j = 0; j < nb; ++j) {
            const float* src = xc + (long long)scol[kk + j] * k;
            float4* dst = ring + j * kLanes + t;
            if (vec && 4 * l < kc) {
              const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
              asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n"
                           :: "r"(d), "l"(src + 4 * l));
            } else {
              *dst = gather_quad(src, 4 * l, kc, vec);
            }
          }
          asm volatile("cp.async.commit_group;\\n" ::);
          asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
          for (int j = 0; j < nb; ++j) {
            close_rows();
            s = fold4<SR>(s, sval[kk], ring[j * kLanes + t]);
            ++kk;
          }
        }
"""


def _cpasync(ring: int) -> list:
    return [("constexpr unsigned kFull = 0xffffffffu;\n",
             f"constexpr unsigned kFull = 0xffffffffu;\n"
             f"constexpr int kRing = {ring};\n"),
            ("  float* sval = reinterpret_cast<float*>(hbuf + CV * G);\n",
             "  float4* ring = hbuf + CV * G;        // cp.async staging\n"
             "  float* sval = reinterpret_cast<float*>(ring + kRing * kLanes);"
             "\n"),
            ("  const int bytes = 16 * kLanes * (ipt + 2) + 12 * a.window;",
             "  const int bytes = 16 * kLanes * (ipt + 2 + kRing) + "
             "12 * a.window;"),
            (_SEG_BATCH, _SEG_CPASYNC)]


#: `gather_quad` with loads cached in L2 only (`ld.global.cg`)
_QUAD_CG = """__device__ __forceinline__ float4 gather_quad_cg(
    const float* __restrict__ p, int c, int kc, bool vec) {
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec) {
    if (c < kc) q = __ldcg(reinterpret_cast<const float4*>(p + c));
    return q;
  }
  if (c < kc) q.x = __ldcg(p + c);
  if (c + 1 < kc) q.y = __ldcg(p + c + 1);
  if (c + 2 < kc) q.z = __ldcg(p + c + 2);
  if (c + 3 < kc) q.w = __ldcg(p + c + 3);
  return q;
}
"""


def _set(old: str, new: str) -> list:
    return [(old, new)]


_TILE = "constexpr int kMaxTile = 4;     // direct kernel's columns a tile"
_CASES = "    SPMM_ELL_DIRECT(4)\n"
_XT_TILE = "constexpr int kMaxXtTile = 16;  // Xt kernel's columns a tile"
_SEG_DEPTH = "template <int G> constexpr int kDepth = G >= 8 ? 4 : 2;"

#: library -> variant -> [(committed text, replacement)]
VARIANTS = {
    "spmm_ell": {
        "tile2": _set(_TILE, _TILE.replace("= 4", "= 2")),
        "tile8": _set(_TILE, _TILE.replace("= 4", "= 8"))
        + _set(_CASES, _CASES + "    SPMM_ELL_DIRECT(8)\n"),
        "tile16": _set(_TILE, _TILE.replace("= 4", "= 16"))
        + _set(_CASES, _CASES + "    SPMM_ELL_DIRECT(8)\n"
               "    SPMM_ELL_DIRECT(16)\n"),
        "xttile8": _set(_XT_TILE, _XT_TILE.replace("= 16", "= 8")),
    },
    "spmm_csr_seg": {
        f"depth{d}": _set(_SEG_DEPTH, "template <int G> constexpr int "
                          f"kDepth = {d};")
        for d in (2, 4, 8)
    } | {
        "group8": _set("constexpr int kMaxGroup = 16;",
                       "constexpr int kMaxGroup = 8;"),
        "cpasync8": _cpasync(8),
        "cpasync12": _cpasync(12),
        "ldcg": _set("              xv[j] = gather_quad(xc + (long long)scol"
                     "[kk + j] * k, 4 * l,",
                     "              xv[j] = gather_quad_cg(xc + (long long)"
                     "scol[kk + j] * k, 4 * l,")
        + _set("constexpr unsigned kFull = 0xffffffffu;\n",
               "constexpr unsigned kFull = 0xffffffffu;\n" + _QUAD_CG),
        "streamio": _set("            y[o] = base != nullptr ? SR::add(__ldg("
                         "base + o), quad_at(val, j))\n"
                         "                                   : quad_at(val, j"
                         ");",
                         "            __stcs(y + o, base != nullptr ? SR::add("
                         "__ldcs(base + o), quad_at(val, j))\n"
                         "                                   : quad_at(val, j"
                         "));"),
        "onecta": _set("__global__ void __launch_bounds__(kLanes, 2)",
                       "__global__ void __launch_bounds__(kLanes, 1)")
        + _set(_SEG_DEPTH, "template <int G> constexpr int kDepth = "
               "G >= 8 ? 8 : 4;"),
    },
}
#: which ELL variants matter on which gather layout
ELL_FOR = {"direct": ("tile2", "tile8", "tile16"),
           "xt": ("xttile8",)}


def fetch_baseline(rev: str) -> int:
    rev = subprocess.run(["git", "-C", str(ROOT), "rev-parse", rev],
                         capture_output=True, text=True,
                         check=True).stdout.strip()
    BASELINE_DIR.mkdir(parents=True, exist_ok=True)
    for name in KERNEL_FILES:
        path = f"src/repro_torch/kernels/csrc/{name}"
        text = subprocess.run(["git", "-C", str(ROOT), "show",
                               f"{rev}:{path}"], capture_output=True,
                              text=True, check=True).stdout
        (BASELINE_DIR / name).write_text(text)
    (BASELINE_DIR / "REV").write_text(rev + "\n")
    print(f"spmm_ab: {rev}'s batched kernel sources in {BASELINE_DIR}")
    return 0


def _nvcc(_build, src_dir: Path, lib: str, out: Path):
    so = out / f"lib{lib}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
           str(src_dir / f"{lib}.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def build_variants(_build, baseline: bool) -> dict:
    """{(library, variant): ctypes library}: the committed ones as
    "committed", the baseline's as "baseline"."""
    _build.build_all()
    libs, procs = {}, []
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
            out = DEV_DIR / f"{lib}-{name}"
            out.mkdir(parents=True, exist_ok=True)
            for h in _build.CSRC.glob("*.cuh"):
                shutil.copy(h, out / h.name)
            (out / f"{lib}.cu").write_text(text)
            procs.append(((lib, name), *_nvcc(_build, out, lib, out)))
        if baseline:
            out = DEV_DIR / f"{lib}-baseline"
            out.mkdir(parents=True, exist_ok=True)
            procs.append(((lib, "baseline"),
                          *_nvcc(_build, BASELINE_DIR, lib, out)))
    for key, so, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"spmm_ab: nvcc failed for {key}:\n{text}")
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
    ap.add_argument("--fetch-baseline", metavar="REV")
    args = ap.parse_args(argv)
    if args.fetch_baseline:
        return fetch_baseline(args.fetch_baseline)
    if not torch.cuda.is_available():
        print("spmm_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.generators import fd_matrix, rmat_matrix
    from repro_torch.graph.semiring import PLUS_TIMES
    from repro_torch.kernels import _build
    from repro_torch.kernels.spmv_ell import gather_layout
    from repro_torch.plan import compile as compile_plan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    baseline = (BASELINE_DIR / "spmm_ell.cu").exists()
    if baseline:
        print("spmm_ab: baseline built from "
              f"{(BASELINE_DIR / 'REV').read_text().strip()}'s sources",
              flush=True)
    else:
        print("spmm_ab: no baseline sources (build/dev/baseline) and no git "
              "history here: the baseline is the previous design's times "
              "as PERF.md records them (§6), ms at k = 4 / 16 / 64: "
              + "; ".join(f"{case} {' / '.join(map(str, t))}"
                          for case, t in RECORDED_BASELINE.items()),
              flush=True)
    dev = torch.device("cuda")
    libs = build_variants(_build, baseline)
    n = 1 << args.log2n
    opts = dict(reorder="none", predictor="none", device=dev)
    ell = compile_plan(fd_matrix(n, device=dev), format="ell", **opts).prep
    hyb = compile_plan(rmat_matrix(n, device=dev), format="hyb", **opts).prep
    layouts = {id(q): gather_layout(q.data, q.idx, PLUS_TIMES.pad_value)
              for q in (ell, hyb.light)}
    print(f"spmm_ab: gather layouts: fd ell {layouts[id(ell)]}, rmat light "
          f"{layouts[id(hyb.light)]}", flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pt = PLUS_TIMES.code
    failures = 0
    for k in (int(v) for v in args.ks.split(",")):
        gen = torch.Generator(device=dev).manual_seed(k)
        X = torch.rand((k, n), generator=gen, device=dev)
        xt = X.t().contiguous()
        base = torch.rand((k, n), generator=gen, device=dev)
        copy_ms = events_ms(lambda: X.t().contiguous(), args.reps)
        for label, lib, p in (("fd ell", "spmm_ell", ell),
                              ("rmat light", "spmm_ell", hyb.light),
                              ("rmat heavy", "spmm_csr_seg", hyb.heavy)):
            outs, calls, needs_copy = {}, {}, {}

            def add(name, make):
                Y = torch.empty((k, n), device=dev)
                outs[name] = Y
                calls[name] = make(Y)

            if lib == "spmm_ell":
                W = p.data.shape[0]
                mine = layouts[id(p)]
                other = "xt" if mine == "direct" else "direct"
                names = [("committed", mine, "committed"),
                         (f"committed-{other}", other, "committed")]
                names += [(v, mine, v) for v in ELL_FOR[mine]]
                for name, layout, build in names:
                    fn = entry(libs[(lib, build)], "spmm_ell_f32",
                               [P] * 4 + [I] * 6 + [P])
                    src = X if layout == "direct" else xt
                    needs_copy[name] = layout == "xt"
                    add(name, lambda Y, fn=fn, src=src, d=layout == "direct":
                        lambda: fn(p.data.data_ptr(), p.idx.data_ptr(),
                                   src.data_ptr(), Y.data_ptr(), n, n, W, k,
                                   d, pt, stream))
                if baseline:
                    fn = entry(libs[(lib, "baseline")], "spmm_ell_f32",
                               [P] * 4 + [I] * 4 + [P])
                    needs_copy["baseline"] = True
                    add("baseline", lambda Y, fn=fn: lambda: fn(
                        p.data.data_ptr(), p.idx.data_ptr(), xt.data_ptr(),
                        Y.data_ptr(), n, W, k, pt, stream))
            else:
                n_win = p.win_row.shape[0] - 1
                builds = ["committed", *VARIANTS[lib]]
                if baseline:
                    builds.append("baseline")
                for name in builds:
                    # (2, n_win, k) here, (2, k, n_win) in the baseline
                    carries = torch.empty((2, k, n_win), device=dev)
                    fn = entry(libs[(lib, name)], "spmm_csr_seg_f32",
                               [P] * 9 + [L] + [I] * 6 + [P])
                    needs_copy[name] = True
                    add(name, lambda Y, fn=fn, c=carries: lambda: fn(
                        p.vals.data_ptr(), p.cols.data_ptr(),
                        p.row_ptr.data_ptr(), p.win_row.data_ptr(),
                        p.split_rows.data_ptr(), xt.data_ptr(),
                        base.data_ptr(), c.data_ptr(), Y.data_ptr(),
                        p.vals.shape[0], n, n_win, p.split_rows.shape[0],
                        p.window, k, pt, stream))
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
            if not baseline and k in RECORDED_KS:
                t = RECORDED_BASELINE[label][RECORDED_KS.index(k)]
                line.append(f"recorded baseline={t:.4f} "
                            f"({t / ms['committed']:.3f}x)")
            print(f"ab {lib} [{label}] k={k}: " + " ".join(line)
                  + f"; interleave copy alone {copy_ms:.4f} ms", flush=True)
            if lib == "spmm_ell":
                print(f"ab {lib} [{label}] k={k} with the copy each needs: "
                      + " ".join(f"{name}={t + copy_ms * needs_copy[name]:.4f}"
                                 for name, t in ms.items()), flush=True)
        del X, xt, base
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
