"""The dry-run's per-rank costs (`repro_torch.launch.steps`'
`LoweredPlan.trace(mesh)`, `launch.dryrun.fake_world`): rank 0's
partitioned step traced on a "fake" world of ranks in this process.

  * per-rank matmul FLOPs of train, prefill and decode on (data 2,
    model 4) and (data 4, model 2), at reduced size, against the
    reference's compiled per-device HLO dots on eight host devices
    (`tests/_dryrun_ranks_reference.py`, a subprocess) -- exactly, every
    difference named as the op behind it;
  * the train step's counted collective wire bytes and calls against
    their closed form: the weights' gathers and the gradients'
    reduce-scatters, the sums over `model` of Megatron's f and g and of
    the vocab-parallel loss, the gradients of replicated leaves, the
    loss's and the norm's sums.

(StableLM-1.6B's train_4k at full size on 16 x 16:
`tests/test_torch_dryrun_full.py`.)
"""
import json
import math
import os
import subprocess
import sys

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import partition
from repro_torch.distributed.sharding import spec_axes, spec_leaves
from repro_torch.launch import dryrun, steps
from repro_torch.models import tuning
from repro_torch.optim import OptimizerConfig
from repro_torch.train.loop import TrainConfig
from repro_torch.tree import leaves_with_path

TESTS = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("stablelm-1.6b", "starcoder2-15b")
MESHES = ((2, 4), (4, 2))
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 8, 64
NESTED = "checkpoint/checkpoint/rematted_computation/"


@pytest.fixture(autouse=True)
def default_knobs():
    """The knobs at their defaults (all on), as the reference's are, and
    as they were after each test."""
    saved = tuning.snapshot()
    for name in saved:
        tuning.set_knob(name, True)
    yield
    for name, v in saved.items():
        tuning.set_knob(name, v)


@pytest.fixture(scope="module")
def reference():
    out = subprocess.run(
        [sys.executable, os.path.join(TESTS, "_dryrun_ranks_reference.py"),
         str(BATCH), str(SEQ), *ARCHS], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _mesh(shape):
    return {"data": shape[0], "model": shape[1]}


def per_rank(cfg, shape, kind, mesh_shape, **kw):
    """Rank 0's counter of the plan's partitioned step."""
    mesh = _mesh(mesh_shape)
    plan = steps.build_plan(cfg, shape, mesh, **kw)
    with dryrun.fake_world(mesh) as dmesh:
        return plan.trace(dmesh), plan, partition.RankLayout(cfg, dmesh)


def kv_duplicate(cfg, mesh_shape, kind):
    """FLOPs of the K and V projections that a rank computes for KV heads
    its model-axis neighbours compute too: where the KV heads do not
    split over `model` (the reduced configs' 2 on 4), each rank projects
    the KV heads its query heads read; the reference's partitioner
    projects each once.  Train: forward, recompute and both backward
    products."""
    d_, m = mesh_shape
    if cfg.n_kv_heads % m == 0:
        return 0
    group = cfg.n_heads // cfg.n_kv_heads
    read = len({t // group for t in range(cfg.n_heads // m)})
    tokens = BATCH * (1 if kind == "decode" else SEQ)
    mine = 2 * (tokens // d_) * cfg.d_model * read * cfg.hd
    ideal = 2 * tokens * cfg.d_model * cfg.n_kv_heads * cfg.hd // (d_ * m)
    return cfg.n_layers * 2 * (mine - ideal) * (4 if kind == "train" else 1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_per_rank_matmul_flops_equal_the_reference_dots(reference, arch,
                                                        mesh_shape, kind):
    rows = reference[f"{arch}|{mesh_shape[0]}x{mesh_shape[1]}|{kind}"]
    ref = sum(r[0] for r in rows)
    # the reference's `tuning.attn_chunk_remat` checkpoints each attention
    # chunk inside the checkpointed block: its backward recomputes QK^T
    # once more (as on one device, `tests/test_torch_roofline.py`)
    nested = sum(r[0] for r in rows if NESTED in r[1])
    cfg = get_config(arch).reduced()
    cc, _, _ = per_rank(cfg, ShapeConfig("t", SEQ, BATCH, kind), kind,
                        mesh_shape)
    dup = kv_duplicate(cfg, mesh_shape, kind)
    if kind != "train":
        assert nested == 0
    assert (dup == 0) == (mesh_shape == (4, 2))
    assert cc.costs().matmul_flops == ref - nested + dup


def _closed_form(cfg, plan, part, mesh_shape):
    """The train step's (wire bytes, calls) by collective kind, without
    remat (`distributed.api`'s conventions: an all-gather its result, a
    reduce-scatter its operand, an all-reduce twice its operand)."""
    d_, m = mesh_shape
    wire, calls = {}, {}

    def add(kind, nbytes, n=1):
        wire[kind] = wire.get(kind, 0) + nbytes * n
        calls[kind] = calls.get(kind, 0) + n

    params = plan.in_specs[0]
    groups = set()
    for (path, x), spec in zip(leaves_with_path(params),
                               spec_leaves(part.param_specs)):
        layers, shape = (x.shape[0], x.shape[1:]) if "'stacks'" in path \
            else (1, x.shape)
        if layers > 1:
            spec = spec[1:]
        named = {a for e in spec for a in spec_axes(e)}
        groups.add(tuple(sorted(named)))
        used = x.element_size() * math.prod(
            n // (m if "model" in spec_axes(spec[i] if i < len(spec)
                                            else None) else 1)
            for i, n in enumerate(shape))
        block = used // d_ if "data" in named else used
        if "data" in named:
            add("all-gather", used, layers)           # FSDP
            add("reduce-scatter", used, layers)       # its backward
        else:
            add("all-reduce", 2 * block, layers)      # rows of every rank
        kv = path.split("'")[-2] in partition.KV_LEAVES
        if kv and not part.kv_split:
            add("all-reduce", 2 * block, layers)      # heads of every rank
    rows = BATCH // d_
    act = 2 * rows * SEQ * cfg.d_model * 2            # bfloat16 (B/D, S, d)
    add("all-reduce", act)                            # the embedding's g
    add("all-reduce", act, 4 * cfg.n_layers)          # f and g, twice
    add("all-reduce", act)                            # the loss's f
    add("all-reduce", 2 * rows * (SEQ // 8) * 4, 3 * 8)   # pmax, 2 sums
    add("all-reduce", 2 * 4, 2)                       # total and count
    for axes in groups:                               # the norm's groups
        add("all-reduce", 2 * 4, len(axes))
    return wire, calls


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_collective_wire_bytes_equal_the_closed_form(mesh_shape):
    cfg = get_config("stablelm-1.6b").reduced()
    tc = TrainConfig(optimizer=OptimizerConfig(), remat="none")
    cc, plan, part = per_rank(cfg, ShapeConfig("t", SEQ, BATCH, "train"),
                              "train", mesh_shape, tc=tc)
    c = cc.costs()
    wire, calls = _closed_form(cfg, plan, part, mesh_shape)
    assert c.collective_bytes == wire
    assert c.collective_counts == calls
