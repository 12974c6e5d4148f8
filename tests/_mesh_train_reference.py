"""The reference's side of the partitioned-step parity tests: run as a
subprocess (the XLA device count is fixed at JAX's first import),

    python tests/_mesh_train_reference.py IN.npz OUT.npz CASE...

For each case ("arch|DxM") it jits `repro.launch.steps.build_train_plan`
for the arch's reduced float32 config at (BATCH, SEQ) on a (data D,
model M) mesh of eight host devices, as the reference's launcher does,
and runs N_STEPS steps from the npz's parameters and batches.  It
writes each step's metrics, step 1's AdamW first moment and the final
parameters and optimizer state.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _mesh_train as W  # noqa: E402
from repro.configs import CONFIGS  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.distributed.api import use_mesh  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.launch.steps import build_train_plan  # noqa: E402
from repro.models import registry  # noqa: E402
from repro.optim import OptimizerConfig, make_optimizer  # noqa: E402
from repro.train.loop import TrainConfig  # noqa: E402


def run_case(data, case):
    arch, shape = W.parse(case)
    cfg = W.config(arch, CONFIGS)
    mesh = make_mesh(shape, ("data", "model"))
    tc = TrainConfig(optimizer=OptimizerConfig(**W.OPT), remat=W.REMAT)
    plan = build_train_plan(cfg, ShapeConfig("t", W.SEQ, W.BATCH, "train"),
                            mesh, tc=tc)
    like = jax.eval_shape(registry.get_model(cfg).init,
                          jax.random.PRNGKey(0))
    n = len(jax.tree.leaves(like))
    params = jax.tree.unflatten(jax.tree.structure(like), [
        jnp.asarray(data[f"{arch}|p{i}"]) for i in range(n)])
    opt = make_optimizer(tc.optimizer)[0](params)
    step = plan.jitted()
    out = {}
    with use_mesh(mesh):
        for s in range(W.N_STEPS):
            batch = {k: jnp.asarray(data[f"{arch}|{k}{s}"])
                     for k in ("tokens", "labels")}
            params, opt, m = step(params, opt, batch)
            for k, v in m.items():
                out[f"{case}|{k}{s}"] = np.asarray(v)
            if s == 0:
                for i, leaf in enumerate(jax.tree.leaves(opt.mu)):
                    out[f"{case}|mu1_{i}"] = np.asarray(leaf)
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{case}|param{i}"] = np.asarray(leaf)
    for i, leaf in enumerate(jax.tree.leaves(tuple(opt[1:]))):
        out[f"{case}|state{i}"] = np.asarray(leaf)
    out[f"{case}|step"] = np.asarray(opt.step)
    return out


if __name__ == "__main__":
    inputs_path, out_path, *cases = sys.argv[1:]
    assert len(jax.devices()) == W.WORLD
    data = np.load(inputs_path)
    out = {}
    for case in cases:
        out.update(run_case(data, case))
    np.savez(out_path, **out)
    print("REFERENCE DONE")
