"""Training launcher: end-to-end driver with checkpoint/restart, heartbeat,
straggler watch and deterministic data replay (counterpart of
`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --reduced --steps 200 --batch 8 --seq 128 --device cpu

Runs on the card unless `--device cpu` is given.  Fault tolerance is
exercised for real: `--fail-at-step N` kills the step loop once at step
N and the Supervisor restores from the last committed checkpoint and
replays data deterministically.  Checkpoints have the reference's
layout, so `repro.checkpoint.manager.CheckpointManager.restore` reads
this launcher's and this launcher resumes from the reference's.  One
device: `--model-parallel` other than 1 waits for training on a mesh
(ROADMAP A11, slice 3f).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import (HeartbeatMonitor,
                                           StragglerDetector, Supervisor)
from repro_torch.launch.steps import optimizer_for
from repro_torch.models import registry
from repro_torch.optim import OptimizerConfig
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_train_step)


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = registry.get_model(cfg)
    opt = optimizer_for(cfg)
    if args.lr:
        opt = OptimizerConfig(name=opt.name, lr=args.lr,
                              warmup_steps=min(100, args.steps // 10 + 1),
                              total_steps=args.steps)
    tc = TrainConfig(optimizer=opt, remat=args.remat,
                     accum_steps=args.accum, n_steps=args.steps,
                     checkpoint_every=args.ckpt_every)
    return cfg, api, tc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject one crash at this step (fault-tolerance "
                         "demo); Supervisor restarts from the checkpoint")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.model_parallel != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: the port trains on "
            "one device; training on a mesh, with gradients through the "
            "collectives, waits for ROADMAP A11, slice 3f")

    dev = resolve_device(args.device)
    cfg, api, tc = build(args)
    mgr = CheckpointManager(args.ckpt_dir)
    hb = HeartbeatMonitor(n_workers=1, timeout_s=300.0)
    straggler = StragglerDetector(k=3.0)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    train_step = make_train_step(api, tc)
    failed_once = {"done": False}

    def make_state():
        """Fresh or checkpoint-restored (params, opt, step)."""
        params, opt_state = init_train_state(
            api, tc, torch.Generator(device=dev).manual_seed(args.seed), dev)
        start = 0
        mgr.wait()
        latest = mgr.latest_step()
        if latest is not None:
            (params, opt_state), start = mgr.restore(
                latest, (params, opt_state))
            start += 1
            print(f"[train] restored step {latest} from {args.ckpt_dir}")
        return {"params": params, "opt": opt_state, "step": start}

    pipe = make_pipeline(data_cfg, device=dev)
    losses = []

    def step_fn(state, step):
        if args.fail_at_step == step and not failed_once["done"]:
            failed_once["done"] = True
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.time()
        batch = pipe.batch_at(step)
        params, opt_state, metrics = train_step(state["params"],
                                                state["opt"], batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        hb.beat(0, step)
        straggler.record(0, dt)
        losses.append((step, loss))
        if step % args.log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if step > 0 and step % tc.checkpoint_every == 0:
            mgr.save(step, (params, opt_state), blocking=False)
        return {"params": params, "opt": opt_state, "step": step + 1}

    sup = Supervisor(max_restarts=3)
    state = sup.run(make_state, step_fn, n_steps=args.steps)
    mgr.save(int(state["step"]) - 1, (state["params"], state["opt"]),
             blocking=True)
    if sup.restarts:
        print(f"[train] survived {sup.restarts} restart(s): {sup.failures}")
    print(f"[train] done at step {state['step']-1}; "
          f"final loss {losses[-1][1]:.4f}; straggler medians "
          f"{straggler.medians()}")
    return losses


if __name__ == "__main__":
    main()
