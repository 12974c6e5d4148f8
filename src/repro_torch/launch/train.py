"""Training launcher: end-to-end driver with checkpoint/restart, heartbeat,
straggler watch and deterministic data replay (counterpart of
`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --reduced --steps 200 --batch 8 --seq 128 --device cpu
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --reduced \
        --model-parallel 2 --device cpu

Runs on the card unless `--device cpu` is given.  Fault tolerance is
exercised for real: `--fail-at-step N` kills the step loop once at step
N and the Supervisor restores from the last committed checkpoint and
replays data deterministically.  Checkpoints have the reference's
layout, so `repro.checkpoint.manager.CheckpointManager.restore` reads
this launcher's and this launcher resumes from the reference's.

The mesh is `launch.mesh.make_local_mesh(model=--model-parallel)` over
the world the launcher runs in: one rank outside a world, the ranks of
a `launch.mesh.World` (or `launch`) that calls `main`, or torchrun's.
On one rank the step is the one-device step; on more, every rank runs
the partitioned step (`distributed.partition`, the dense decoders) on
its blocks of the state and its rows of each batch.  Every rank starts
from the same seeded global state (or the checkpoint's global arrays)
and cuts its blocks; rank 0 writes the checkpoints, the state assembled
from every rank's blocks.  Each rank injects the failure, beats the
heartbeat and records its step times under its own rank.  A family the
partitioned step does not cover refuses a model axis above 1 (ROADMAP
A11, slice 3g).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import (HeartbeatMonitor,
                                           StragglerDetector, Supervisor)
from repro_torch.distributed import partition, sharding
from repro_torch.launch.mesh import make_local_mesh
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
    cfg, api, tc = build(args)
    if args.model_parallel != 1:
        partition.require_partitioned(cfg)
    dev = resolve_device(args.device)
    owned = not dist.is_initialized()
    try:
        mesh = make_local_mesh(model=args.model_parallel, device=dev)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        return _train(args, cfg, api, tc, dev, mesh)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


class _State:
    """What a rank holds: the global state on one rank, its blocks on a
    mesh (and how to cut them from, and assemble them into, the global
    state a checkpoint holds)."""

    def __init__(self, cfg, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.part = partition.RankLayout(cfg, mesh) \
            if partition.is_partitioned(mesh) else None
        self.ospecs = None

    def cut(self, params, opt_state):
        if self.part is None:
            return params, opt_state
        self.ospecs = sharding.opt_state_specs(opt_state, params, self.cfg,
                                               self.mesh)
        return (partition.cut(params, self.part.param_specs, self.mesh),
                partition.cut(opt_state, self.ospecs, self.mesh))

    def whole(self, params, opt_state):
        if self.part is None:
            return params, opt_state
        return (partition.assemble(params, self.part.param_specs,
                                   self.mesh),
                partition.assemble(opt_state, self.ospecs, self.mesh))

    def batch(self, batch):
        if self.part is None:
            return batch
        return partition.batch_block(batch, self.mesh)


def _train(args, cfg, api, tc, dev, mesh):
    rank, world = dist.get_rank(), dist.get_world_size()
    lead = rank == 0
    mgr = CheckpointManager(args.ckpt_dir)
    hb = HeartbeatMonitor(n_workers=world, timeout_s=300.0)
    straggler = StragglerDetector(k=3.0)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)
    held = _State(cfg, mesh)
    train_step = make_train_step(api, tc, mesh)
    failed_once = {"done": False}

    def say(line):
        if lead:
            print(line)

    def make_state():
        """Fresh or checkpoint-restored (params, opt, step)."""
        params, opt_state = init_train_state(
            api, tc, torch.Generator(device=dev).manual_seed(args.seed), dev)
        start = 0
        mgr.wait()
        if world > 1:
            dist.barrier()          # rank 0's checkpoint is committed
        latest = mgr.latest_step()
        if latest is not None:
            (params, opt_state), start = mgr.restore(
                latest, (params, opt_state))
            start += 1
            say(f"[train] restored step {latest} from {args.ckpt_dir}")
        params, opt_state = held.cut(params, opt_state)
        return {"params": params, "opt": opt_state, "step": start}

    def save(step, params, opt_state, blocking):
        state = held.whole(params, opt_state)
        if lead:
            mgr.save(step, state, blocking=blocking)

    pipe = make_pipeline(data_cfg, device=dev)
    losses = []

    def step_fn(state, step):
        if args.fail_at_step == step and not failed_once["done"]:
            failed_once["done"] = True
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.time()
        batch = held.batch(pipe.batch_at(step))
        params, opt_state, metrics = train_step(state["params"],
                                                state["opt"], batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        hb.beat(rank, step)
        straggler.record(rank, dt)
        losses.append((step, loss))
        if step % args.log_every == 0:
            say(f"[train] step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        if step > 0 and step % tc.checkpoint_every == 0:
            save(step, params, opt_state, blocking=False)
        return {"params": params, "opt": opt_state, "step": step + 1}

    sup = Supervisor(max_restarts=3)
    state = sup.run(make_state, step_fn, n_steps=args.steps)
    save(int(state["step"]) - 1, state["params"], state["opt"],
         blocking=True)
    if sup.restarts:
        say(f"[train] survived {sup.restarts} restart(s): {sup.failures}")
    say(f"[train] done at step {state['step']-1}; "
        f"final loss {losses[-1][1]:.4f}; straggler medians "
        f"{straggler.medians()}")
    return losses


if __name__ == "__main__":
    main()
