"""Serving launcher: batched-request demo over the decode engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --layers 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --device cpu --requests 16 --max-new 12

Drives the continuous-batching engine (serve/engine.py) with a synthetic
request trace: mixed prompt lengths, per-request token budgets, over
seeded weights.  Prints per-request outputs and scheduler statistics
(pool utilization, preemptions, steps).  Runs on the card unless
`--device cpu` is given; a kernel's error is never caught.  Every
decoder config serves (dense, MoE, the Mamba hybrid, RWKV); `--layers`
cuts the depth, as a model whose weights outgrow the device needs
(Jamba's 32 layers hold 104 GB in bfloat16, one period of 8 holds 26.5).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.serve import EngineConfig, Request, make_engine


def synthetic_requests(n: int, vocab: int, max_new: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(4, 48))
        prompt = rng.integers(1, vocab, size=plen).tolist()
        out.append(Request(req_id=i, prompt=prompt,
                           max_new_tokens=int(rng.integers(4, max_new + 1))))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the first N layers (depth cut)")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-context", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    if cfg.is_encdec:
        raise SystemExit("serve launcher drives decoder-only archs")

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        need = cfg.param_count() * (2 if cfg.dtype == "bfloat16" else 4)
        have = torch.cuda.get_device_properties(dev).total_memory
        if need > 0.9 * have:
            raise SystemExit(
                f"{cfg.name}: {cfg.n_layers} layers hold {need / 1e9:.1f} "
                f"GB of weights, the device {have / 1e9:.1f} GB; cut the "
                "depth with --layers")
    eng = make_engine(
        cfg, gen=torch.Generator(device=dev).manual_seed(args.seed),
        device=dev, ecfg=EngineConfig(
            max_batch=args.max_batch, max_context=args.max_context,
            block_size=args.block_size, temperature=args.temperature,
            seed=args.seed))
    reqs = synthetic_requests(args.requests, cfg.vocab, args.max_new,
                              args.seed)
    t0 = time.time()
    out = eng.run(reqs)
    dt = time.time() - t0
    n_tok = sum(len(v) for v in out.values())
    for rid in sorted(out):
        print(f"[serve] req {rid:3d}: {out[rid]}")
    stats = eng.sched.stats()
    print(f"[serve] {len(out)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/max(dt,1e-9):.1f} tok/s) on {dev}; stats={stats}")
    return out, stats


if __name__ == "__main__":
    main()
