"""The reference's side of the mesh parity tests: run as a subprocess
(the XLA device count is fixed at JAX's first import),

    python tests/_mesh_reference.py {paths,auto,collectives} IN.npz OUT.npz

it runs `tests/_mesh_worlds.py`'s cases through `repro` on eight host
devices and writes the results to OUT.npz.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import _mesh_worlds as W  # noqa: E402
from repro.configs import CONFIGS  # noqa: E402
from repro.distributed import collectives, pipeline  # noqa: E402
from repro.distributed.api import use_mesh  # noqa: E402
from repro.distributed.compat import shard_map  # noqa: E402
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import moe, tuning  # noqa: E402
from repro.optim import grad_compress  # noqa: E402


def _inputs(data, arch, dtype):
    dt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    p, xs = {}, {}
    for key in data.files:
        a, k = key.split("|")
        if a != arch:
            continue
        v = jnp.asarray(data[key])
        if k == "p_router":
            p["router"] = v
        elif k.startswith("p_"):
            p[k[2:]] = v.astype(dt)
        else:
            xs[k[2:]] = v.astype(dt)
    return p, xs


def run_moe(inputs_path, which):
    data = np.load(inputs_path)
    meshes = {"dm": make_mesh(*W.MESH),
              "data": make_mesh((W.WORLD,), ("data",)), None: None}
    knobs = tuning.snapshot()
    out = {}
    for case in W.CASES[which]():
        arch, cf, dtype, what = W.parse(case)
        cfg = W.moe_config(arch, cf, dtype, CONFIGS)
        p, xs = _inputs(data, arch, dtype)
        if what.startswith("auto-"):
            mesh_kind, x_kind, _, _ = W.AUTO[what[5:]]
            fn = moe.apply_moe_auto
        else:
            mesh_kind = "dm"
            x_kind = "decode" if what == "decode" else "prefill"
            fn = getattr(moe, f"apply_moe_{what}")
        for k, v in W.case_knobs(case).items():
            tuning.set_knob(k, v)
        call = jax.jit(lambda p, x: fn(p, cfg, x))
        if meshes[mesh_kind] is None:
            y, aux = call(p, xs[x_kind])
        else:
            with use_mesh(meshes[mesh_kind]):
                y, aux = call(p, xs[x_kind])
        for k, v in knobs.items():
            tuning.set_knob(k, v)
        out[case] = np.asarray(y, np.float32)
        out[case + "|balance"] = np.asarray(aux["moe_balance"])
        out[case + "|zloss"] = np.asarray(aux["moe_zloss"])
    return out


def run_collectives(inputs_path):
    d = {k: jnp.asarray(v) for k, v in np.load(inputs_path).items()}
    dm = make_mesh(*W.MESH)
    out = {}
    out["ring"] = shard_map(
        lambda x, w: collectives.ring_allgather_matmul(x, w, "model"),
        mesh=dm, in_specs=(P(None, None), P("model", None)),
        out_specs=P(None, None), check_vma=False)(d["ring_x"], d["ring_w"])
    out["lse"] = shard_map(
        lambda q, k, v, valid: collectives.lse_merge_attention(
            q, k, v, "model", valid), mesh=dm,
        in_specs=(P(), P(None, "model", None, None),
                  P(None, "model", None, None), P(None, "model")),
        out_specs=P(), check_vma=False)(
        d["lse_q"], d["lse_k"], d["lse_v"], d["lse_valid"])
    grads = {"a": d["rs_a"], "b": d["rs_b"], "c": d["rs_c"]}
    rs = shard_map(
        lambda g: collectives.reduce_scatter_grads(
            {k: v[0] for k, v in g.items()}, "model"), mesh=dm,
        in_specs=(P("model"),),
        out_specs={"a": P("model"), "b": P(), "c": P()},
        check_vma=False)(grads)
    out.update({f"rs_{k}": v for k, v in rs.items()})
    for tag, shape, axes in (("pd", (2, 4), ("pod", "data")),
                             ("pdm", (2, 2, 2), ("pod", "data", "model"))):
        mesh = make_mesh(shape, axes)

        def cross(g, r):
            state = grad_compress.CompressionState(
                residual={k: v[0] for k, v in r.items()})
            red, new = grad_compress.crosspod_allreduce_compressed(
                {k: v[0] for k, v in g.items()}, state, "pod")
            return red, {k: v[None] for k, v in new.residual.items()}

        red, res = shard_map(cross, mesh=mesh, in_specs=(P("pod"), P("pod")),
                             out_specs=(P(), P("pod")), check_vma=False)(
            {"w": d["cp_w"], "b": d["cp_b"]},
            {"w": d["cp_rw"], "b": d["cp_rb"]})
        out.update({f"cp_{tag}_{k}": v for k, v in red.items()})
        out.update({f"cp_{tag}_r{k}": v for k, v in res.items()})
    cfg = pipeline.PipelineConfig(W.PIPE["n_stages"],
                                  W.PIPE["n_microbatches"],
                                  axis_name="stage")
    stacked, stage_fn = pipeline.make_pipelined_mlp(
        cfg, list(W.PIPE["widths"]), jax.random.PRNGKey(0))
    stage_mesh = make_mesh((2, 4), ("data", "stage"))
    out["pipe"] = shard_map(
        lambda prm, x: pipeline.pipeline_apply(stage_fn, cfg, prm[0], x),
        mesh=stage_mesh, in_specs=(P("stage"), P()), out_specs=P("stage"),
        check_vma=False)(stacked, d["pipe_x"])
    out["pipe_weights"] = stacked
    # each device's block, by mesh coordinate: (coords, dims, start/stop)
    bmesh = make_mesh(*W.BLOCK_MESH)
    for i, spec in enumerate(W.BLOCK_SPECS):
        index = NamedSharding(bmesh, P(*spec)).devices_indices_map((8, 8))
        out[f"blocks_{i}"] = np.array([
            [[sl.start or 0, 8 if sl.stop is None else sl.stop]
             for sl in index[bmesh.devices[c]]]
            for c in np.ndindex(*W.BLOCK_MESH[0])])
    out["pipe_oracle"] = pipeline.reference_apply(stacked, d["pipe_x"])
    return {k: np.asarray(v) for k, v in out.items()}


if __name__ == "__main__":
    mode, inputs_path, out_path = sys.argv[1:4]
    assert len(jax.devices()) == W.WORLD
    if mode == "collectives":
        out = run_collectives(inputs_path)
    else:
        out = run_moe(inputs_path, mode)
    np.savez(out_path, **out)
    print("REFERENCE DONE")
