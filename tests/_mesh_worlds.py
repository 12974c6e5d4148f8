"""The port's side of the mesh parity tests (`tests/test_torch_mesh_moe.py`,
`tests/test_torch_collectives.py`): the inputs both packages get, the
cases, and the functions the port's ranks run.

The ranks are spawned processes (`repro_torch.launch.mesh.launch`), so
this module imports neither JAX nor the reference: the reference runs
the same cases in a subprocess with eight host devices
(`tests/_mesh_reference.py`), reading the inputs this module writes.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs import CONFIGS
from repro_torch.distributed import api, collectives, pipeline
from repro_torch.distributed.api import P, shard_map, use_mesh
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe, tuning
from repro_torch.optim import grad_compress

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 8
MESH = ((2, 4), ("data", "model"))
MOE_ARCHS = ("jamba-v0.1-52b", "arctic-480b", "kimi-k2-1t-a32b")
CFS = (8.0, 1.25)                   # no drops; the configs' own factor
DTYPES = ("float32", "bfloat16")
PATHS = ("sharded", "a2a", "decode")
#: token shapes; the global layer's capacity under a mesh must split
#: over dp in the reference (its `constrain(buf, "model", "dp", None)`)
SHAPES = {"prefill": (4, 8), "decode": (8, 1), "odd": (3, 16),
          "wide": (4, 16)}

#: apply_moe_auto's branches: (mesh, input, knobs, the path it takes)
AUTO = {
    "a2a": ("dm", "prefill", {"moe_all_to_all": True}, "a2a"),
    "sharded": ("dm", "prefill", {"moe_all_to_all": False}, "sharded"),
    "decode": ("dm", "decode", {"moe_decode_weight_stationary": True},
               "decode"),
    "decode-knob-off": ("dm", "decode",
                        {"moe_decode_weight_stationary": False,
                         "moe_all_to_all": True}, "sharded"),
    "odd-batch": ("dm", "odd", {}, "global"),
    "no-model-axis": ("data", "wide", {}, "global"),
    "no-mesh": (None, "prefill", {}, "global"),
}


def run_reference(mode, inputs, out):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), TESTS]))
    return subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "_mesh_reference.py"), mode,
         str(inputs), str(out)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, out):
    stdout, stderr = proc.communicate(timeout=600)
    assert "REFERENCE DONE" in stdout, stderr[-3000:]
    return np.load(out)


def moe_worlds(tmp_dir, which):
    """(the reference's results, every port rank's results) of one group
    of MoE cases: the reference's subprocess and the port's 8-rank gloo
    world run side by side on one npz of inputs."""
    from repro_torch.launch.mesh import launch

    inputs, out = tmp_dir / "inputs.npz", tmp_dir / "reference.npz"
    write_moe_inputs(inputs)
    proc = run_reference(which, inputs, out)
    try:
        ranks = launch(moe_world, WORLD, device="cpu",
                       args=(str(inputs), which))
    finally:
        ref = finish(proc, out)
    return ref, ranks


def check_case(worlds, case, bf16_tol):
    """The port's case against the reference's: float32 within rtol 1e-5
    (decode: one bfloat16 ulp, its combine being a bfloat16 psum in
    both), bfloat16 within `bf16_tol`; every rank the same bits; a
    replay bit for bit; the path taken is the case's."""
    ref, ranks = worlds
    y, bal, z, taken, same, direct = ranks[0][case]
    for other in ranks[1:]:
        assert np.array_equal(other[case][0], y), "ranks disagree"
    assert same, "a replay differs from the first run"
    assert direct, f"not bit-equal to a direct call of {taken}"
    _, _, dtype, what = parse(case)
    if dtype == "bfloat16":
        tol = bf16_tol
    elif what.endswith("decode"):
        tol = dict(rtol=2.0 ** -8, atol=1e-6)
    else:
        tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y, ref[case], **tol)
    np.testing.assert_allclose(bal, ref[case + "|balance"], **tol)
    np.testing.assert_allclose(z, ref[case + "|zloss"], **tol)
    return taken


def moe_config(arch, cf, dtype, configs=CONFIGS):
    cfg = configs[arch].reduced()
    return dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def case_knobs(case):
    """The knobs a case runs with, in both packages: the sharded combine
    sums over 'model' in the case's dtype."""
    _, _, dtype, what = parse(case)
    knobs = {"moe_combine_bf16": dtype == "bfloat16"}
    if what.startswith("auto-"):
        knobs.update(AUTO[what[5:]][2])
    return knobs


def path_cases():
    return [f"{arch}|{cf}|{dtype}|{path}" for arch in MOE_ARCHS
            for cf in CFS for dtype in DTYPES for path in PATHS]


def auto_cases():
    return [f"{arch}|{cf}|float32|auto-{branch}" for arch in MOE_ARCHS
            for cf in CFS for branch in AUTO]


CASES = {"paths": path_cases, "auto": auto_cases}


def parse(case):
    arch, cf, dtype, what = case.split("|")
    return arch, float(cf), dtype, what


def moe_inputs(arch, seed=5):
    """float32 numpy parameters of a reduced config's MoE layer and
    one-hot tokens (exact routing: x @ router is a row of the router,
    whose rows are seeded logits skewed to expert 0, so the shards drop
    slots at the configs' own capacity factor)."""
    cfg = CONFIGS[arch].reduced()
    m, d = cfg.moe, cfg.d_model
    e, ff = m.n_experts, m.d_expert_ff
    rng = np.random.default_rng(seed)
    router = rng.normal(size=(d, e)).astype(np.float32)
    router[:, 0] += 1.0
    out = {"p_router": router}
    for name, shape in (("w_gate", (e, d, ff)), ("w_up", (e, d, ff)),
                        ("w_down", (e, ff, d))):
        out["p_" + name] = (rng.normal(size=shape) * 0.1).astype(np.float32)
    for name, shape in (("shared_gate", (1, d, ff)),
                        ("shared_up", (1, d, ff)),
                        ("shared_down", (1, ff, d))):
        if m.n_shared_experts:
            out["p_" + name] = (rng.normal(size=shape)
                                * 0.1).astype(np.float32)
    for name, shape in SHAPES.items():
        out["x_" + name] = np.eye(d, dtype=np.float32)[
            rng.integers(0, d, size=shape)]
    return out


def write_moe_inputs(path):
    np.savez(path, **{f"{arch}|{k}": v for arch in MOE_ARCHS
                      for k, v in moe_inputs(arch).items()})


def _torch_inputs(data, arch, dtype):
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    p, xs = {}, {}
    for key in data.files:
        a, k = key.split("|")
        if a != arch:
            continue
        t = torch.from_numpy(data[key])
        if k == "p_router":
            p["router"] = t
        elif k.startswith("p_"):
            p[k[2:]] = t.to(dt)
        else:
            xs[k[2:]] = t.to(dt)
    return p, xs


def _record(fn):
    """(y, aux, the mesh path taken or "global") of one call."""
    before = dict(moe.CALLS)
    y, aux = fn()
    taken = [k for k in moe.CALLS if moe.CALLS[k] != before.get(k, 0)]
    return y, aux, taken[0] if taken else "global"


def moe_world(rank, inputs_path, which):
    """The cases of `which` ("paths" or "auto") on this rank: {case: (y,
    balance, zloss, the path taken, a replay bit-equal, bit-equal to a
    direct call of the path taken)} as numpy."""
    data = np.load(inputs_path)
    meshes = {"dm": make_mesh(*MESH), "data": make_mesh((WORLD,), ("data",)),
              None: None}   # use_mesh(None): no mesh, as outside one
    out = {}
    knobs = tuning.snapshot()
    try:
        for case in CASES[which]():
            arch, cf, dtype, what = parse(case)
            cfg = moe_config(arch, cf, dtype)
            p, xs = _torch_inputs(data, arch, dtype)
            if what.startswith("auto-"):
                mesh_kind, x_kind, _, _ = AUTO[what[5:]]
                fn = moe.apply_moe_auto
            else:
                mesh_kind = "dm"
                x_kind = "decode" if what == "decode" else "prefill"
                fn = getattr(moe, f"apply_moe_{what}")
            for k, v in case_knobs(case).items():
                tuning.set_knob(k, v)
            with use_mesh(meshes[mesh_kind]):
                runs = [_record(lambda: fn(p, cfg, xs[x_kind]))
                        for _ in range(2)]
                taken = runs[0][2]
                direct = getattr(moe, f"apply_moe_{taken}", None) \
                    if taken != "global" else moe.apply_moe
                y3, _ = direct(p, cfg, xs[x_kind])
            for k, v in knobs.items():
                tuning.set_knob(k, v)
            (y, aux, _), (y2, aux2, _) = runs
            same = torch.equal(y.float(), y2.float()) and all(
                torch.equal(aux[k], aux2[k]) for k in aux)
            out[case] = (y.float().numpy(), float(aux["moe_balance"]),
                         float(aux["moe_zloss"]), taken, same,
                         torch.equal(y.float(), y3.float()))
    finally:
        for k, v in knobs.items():
            tuning.set_knob(k, v)
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

#: specs whose blocks are held against `NamedSharding`'s on a (pod 2,
#: data 2, model 2) mesh
BLOCK_SPECS = ((("pod", "data"), "model"), ("model", ("data", "pod")),
               (None, ("pod", "data", "model")), ("data",))
BLOCK_MESH = ((2, 2, 2), ("pod", "data", "model"))

PIPE = dict(n_stages=4, n_microbatches=8, widths=(16,) * 9,
            x_shape=(8, 4, 16))


def collective_inputs(seed=6):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    b, s = 2, 32
    lengths = np.array([5, 29])
    out = {
        "ring_x": f(8, 32), "ring_w": f(32, 16),
        # GQA: 4 query heads on 2 KV heads, seeded valid lengths
        "lse_q": f(b, 4, 1, 16), "lse_k": f(b, s, 2, 16),
        "lse_v": f(b, s, 2, 16),
        "lse_valid": np.arange(s)[None, :] < lengths[:, None],
        # one gradient tree a model member (leading dim 4)
        "rs_a": f(4, 8, 3), "rs_b": f(4, 5), "rs_c": f(4),
        # one gradient tree and residual a pod (leading dim 2)
        "cp_w": f(2, 16, 8), "cp_b": f(2, 7), "cp_rw": f(2, 16, 8) * 0.01,
        "cp_rb": f(2, 7) * 0.01,
        "pipe_x": f(*PIPE["x_shape"]),
    }
    return out


def collectives_world(rank, inputs_path, pipe_weights):
    """The collectives on this rank's meshes: {name: numpy}."""
    d = {k: torch.from_numpy(v) for k, v in np.load(inputs_path).items()}
    dm = make_mesh(*MESH)
    out = {}

    out["ring"] = shard_map(
        lambda x, w: collectives.ring_allgather_matmul(x, w, "model"), dm,
        in_specs=(P(None, None), P("model", None)),
        out_specs=P(None, None))(d["ring_x"], d["ring_w"])

    out["lse"] = shard_map(
        lambda q, k, v, valid: collectives.lse_merge_attention(
            q, k, v, "model", valid), dm,
        in_specs=(P(), P(None, "model", None, None),
                  P(None, "model", None, None), P(None, "model")),
        out_specs=P())(d["lse_q"], d["lse_k"], d["lse_v"], d["lse_valid"])

    grads = {"a": d["rs_a"], "b": d["rs_b"], "c": d["rs_c"]}
    rs = shard_map(
        lambda g: collectives.reduce_scatter_grads(
            {k: v[0] for k, v in g.items()}, "model"), dm,
        in_specs=(P("model"),),
        out_specs={"a": P("model"), "b": P(), "c": P()})(grads)
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

        red, res = shard_map(cross, mesh, in_specs=(P("pod"), P("pod")),
                             out_specs=(P(), P("pod")))(
            {"w": d["cp_w"], "b": d["cp_b"]},
            {"w": d["cp_rw"], "b": d["cp_rb"]})
        out.update({f"cp_{tag}_{k}": v for k, v in red.items()})
        out.update({f"cp_{tag}_r{k}": v for k, v in res.items()})

    cfg = pipeline.PipelineConfig(PIPE["n_stages"], PIPE["n_microbatches"],
                                  axis_name="stage")
    stage_mesh = make_mesh((2, 4), ("data", "stage"))
    _, stage_fn = pipeline.make_pipelined_mlp(
        cfg, PIPE["widths"], torch.Generator().manual_seed(0), "cpu")
    stacked = torch.from_numpy(pipe_weights)
    out["pipe"] = shard_map(
        lambda prm, x: pipeline.pipeline_apply(stage_fn, cfg, prm[0], x),
        stage_mesh, in_specs=(P("stage"), P()), out_specs=P("stage"))(
        stacked, d["pipe_x"])
    out["pipe_oracle"] = pipeline.reference_apply(stacked, d["pipe_x"])
    out["rank_coordinate"] = torch.tensor(dm.get_coordinate())
    out["transport"] = api.transport(dm, "model")
    return {k: v.numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# the card: four ranks on one card (tests/test_torch_gpu.py)
# ---------------------------------------------------------------------------

CARD_PATHS = (("sharded", "1x4"), ("a2a", "1x4"), ("sharded", "2x2"),
              ("a2a", "2x2"), ("decode", "2x2"))


def card_moe_world(rank):
    """Each MoE path of the reduced Kimi K2 config (shared experts too)
    at capacity factor 8 in float32 on this rank's card, against the
    global layer on the same card: {path mesh: (max abs err, max |y|,
    replay bit-equal)}."""
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = moe_config("kimi-k2-1t-a32b", 8.0, "float32")
    g = torch.Generator(device=dev).manual_seed(7)
    p = moe.init_moe(g, cfg, dev)
    x = torch.randn(4, 16, cfg.d_model, generator=g, device=dev)
    xd = torch.randn(8, 1, cfg.d_model, generator=g, device=dev)
    meshes = {"1x4": make_mesh((1, 4), ("data", "model")),
              "2x2": make_mesh((2, 2), ("data", "model"))}
    combine = tuning.moe_combine_bf16
    tuning.set_knob("moe_combine_bf16", False)
    out = {}
    try:
        for path, mname in CARD_PATHS:
            xin = xd if path == "decode" else x
            want, _ = moe.apply_moe(p, cfg, xin)
            fn = getattr(moe, f"apply_moe_{path}")
            with use_mesh(meshes[mname]):
                y1, _ = fn(p, cfg, xin)
                y2, _ = fn(p, cfg, xin)
            out[f"{path} {mname}"] = (float((y2 - want).abs().max()),
                                      float(want.abs().max()),
                                      torch.equal(y1, y2))
    finally:
        tuning.set_knob("moe_combine_bf16", combine)
    return out


# ---------------------------------------------------------------------------
# the world itself
# ---------------------------------------------------------------------------

def rank_and_world(rank):
    return rank, torch.distributed.get_world_size()


def fail_on_rank_one(rank):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    torch.distributed.barrier()     # rank 0 waits in a collective
    return rank
