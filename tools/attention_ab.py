#!/usr/bin/env python3
"""Time this checkout's attention kernels against another checkout's on
one card, at `chip_smoke.py`'s shapes, in turns.

    git archive <commit> | tar -x -C build/base    # a directory .gitignore lists
    python3 tools/attention_ab.py --baseline build/base

Both checkouts' `repro_torch.kernels` (the baseline's loaded as the
package `repro_torch_base`, built into its own `build/`) run on the same
card tensors: `flash_attention` in float32, causal, batch 4 x 32 heads x
2048 tokens of head_dim 128, and `paged_attention` in bfloat16 and
float32 over the smoke's 64 churned sequences (GQA 32/8, 16-token
blocks).  Each is timed with CUDA events in the order baseline, this,
this, baseline; the two outputs' largest difference is printed beside
the times.  The baseline's paged kernel instances get the SASS lines that
`chip_smoke.py` prints for this checkout's (registers, local memory,
loads issued before their first use).  Last, float32 flash accuracy on
a peaked softmax (q scaled by 8; 2 x 256 tokens, d 128, causal) and an
unscaled one, against float64 on the card: each checkout's kernel and
plain version, as multiples of the float32 check's tolerance (rtol 1e-4,
atol 1e-5).  Prints the card's name and power limit first; exits nonzero
without a card.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def load_package(src: Path, name: str):
    """The `repro_torch` package under `src`, imported as `name`."""
    spec = importlib.util.spec_from_file_location(
        name, src / "repro_torch" / "__init__.py",
        submodule_search_locations=[str(src / "repro_torch")])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.kernels")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, required=True,
                    help="root of the other checkout")
    ap.add_argument("--reps", type=int, default=20,
                    help="launches per timing")
    ap.add_argument("--sass-out", type=Path, default=None,
                    help="directory for the baseline's paged SASS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import kernels as new, serve

    base = load_package(args.baseline.resolve() / "src", "repro_torch_base")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    for k in (new, base):
        k._build.build_all()
    cs.paged_sass(str(base._build.library_path("paged_attention")),
                  f"baseline ({args.baseline.name})",
                  ("bf16 d128 g4", "f32 d128 g4"), args.sass_out)

    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    g = cs.N_HEADS // cs.N_KV_HEADS
    bh, seq = 4 * cs.N_HEADS, 2048
    q = randn((bh, seq, cs.HEAD_DIM), torch.float32)
    k, v = (randn((bh // g, seq, cs.HEAD_DIM), torch.float32)
            .repeat_interleave(g, dim=0) for _ in range(2))
    cases = [("flash_attention f32 causal 4 x 32 x 2048",
              lambda K: K.flash_attention(q, k, v, True, None))]

    cfg, _, lengths, tables = cs.paged_tables(64, 4096, 5, serve)
    pool = serve.init_pool(cfg, cs.N_KV_HEADS, cs.HEAD_DIM, 1,
                           dtype=torch.bfloat16, device=dev)
    for t in pool.values():
        t.copy_(randn(t.shape, torch.bfloat16))
    tables_t = torch.from_numpy(tables).to(dev)
    lengths_t = torch.from_numpy(lengths).to(dev)
    q_dec = randn((len(lengths), cs.N_HEADS, cs.HEAD_DIM), torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        qq, kp, vp = (t.to(dt) for t in (q_dec, pool["k"][0], pool["v"][0]))
        cases.append((f"paged_attention {str(dt).split('.')[-1]} 64 seqs",
                      lambda K, a=(qq, kp, vp):
                          K.paged_attention(*a, tables_t, lengths_t)))

    for label, run in cases:
        diff = float((run(new).float() - run(base).float()).abs().max())
        t = {"baseline": [], "this": []}
        for who in ("baseline", "this", "this", "baseline"):
            K = base if who == "baseline" else new
            t[who].append(cs.time_ms(lambda K=K: run(K), args.reps, dev))
        print(f"ab {label}: baseline_ms={t['baseline'][0]:.4f},"
              f"{t['baseline'][1]:.4f} this_ms={t['this'][0]:.4f},"
              f"{t['this'][1]:.4f} max_abs_diff={diff:.3g}", flush=True)

    def exact(q, k, v):
        q, k, v = q.double(), k.double(), v.double()
        s = q @ k.transpose(1, 2) / q.shape[-1] ** 0.5
        i = torch.arange(s.shape[1], device=dev)
        s = torch.where(i[:, None] >= i[None, :], s, -torch.inf)
        return torch.softmax(s, -1) @ v

    def tol(a, b):
        return float(((a.double() - b.double()).abs()
                      / (1e-5 + 1e-4 * b.double().abs())).max())

    for seed, scale in ((0, 8.0), (10, 8.0), (20, 8.0), (0, 1.0)):
        cpu = torch.Generator().manual_seed(seed)
        q, k, v = (torch.randn((2, 256, 128), generator=cpu).to(dev)
                   for _ in range(3))
        q = q * scale
        ex = exact(q, k, v)
        line = []
        for who, K in (("baseline", base), ("this", new)):
            kern = K.flash_attention(q, k, v, True)
            plain = K.flash_attention_plain(q, k, v, True)
            line.append(f"{who}: plain-vs-float64 {tol(plain, ex):.3f} "
                        f"kernel-vs-float64 {tol(kern, ex):.3f} "
                        f"kernel-vs-plain {tol(kern, plain):.3f}")
        print(f"ab accuracy flash f32 seed {seed} q x {scale:g} (in "
              f"tolerances): " + "; ".join(line), flush=True)
    return 1 if cs.FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
