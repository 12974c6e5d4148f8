"""Parity of the port's mesh layer (`repro_torch.distributed.api`,
`repro_torch.distributed.sharding`, `repro_torch.launch.mesh`) with the
reference's, in this process.

The sharding rules take a plain {axis: size} mesh in the port and an
abstract mesh (`jax.sharding.AbstractMesh`) in the reference, so both
evaluate at the production shapes -- (data 16, model 16) and (pod 2,
data 16, model 16) -- and at (data 2, model 4) without that many
devices.  Parameter, optimizer-state (AdamW and Adafactor), batch and
cache specs of all ten archs at full size must be equal leaf for leaf,
over the reference's own shape trees (`jax.eval_shape`).  (The block a
rank cuts for a spec is held against `NamedSharding`'s on eight devices
in `tests/test_torch_collectives.py`.)
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import CONFIGS as R_CONFIGS, SHAPES as R_SHAPES
from repro.configs.base import applicable_shapes
from repro.distributed import api as rapi, sharding as rsh
from repro.launch.mesh import make_local_mesh as r_local_mesh
from repro.launch.mesh import mesh_dict as r_mesh_dict
from repro.models import registry as rreg
from repro.optim import adamw as radamw
from repro_torch.configs import CONFIGS
from repro_torch.distributed import api, sharding
from repro_torch.distributed.api import P
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import adamw as tadamw

ARCHS = sorted(R_CONFIGS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
LOGICAL = (None, "dp", "dpm", "data", "model", "pod", "stage", "kv_model")


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def to_port(tree):
    """The reference's shape tree with meta tensors for its leaves and
    the port's optimizer states for its NamedTuples."""
    if isinstance(tree, dict):
        return {k: to_port(v) for k, v in tree.items()}
    if hasattr(type(tree), "_fields"):
        cls = getattr(tadamw, type(tree).__name__)
        assert cls._fields == type(tree)._fields
        return cls(*(to_port(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_port(v) for v in tree)
    if tree is None:
        return None
    return torch.empty(tree.shape, device="meta")


def normal(entry):
    """A spec entry as `PartitionSpec` compares it: ("data",) is "data"."""
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def flat_specs(tree):
    """[spec as a tuple] in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, (P, PartitionSpec)):
        return [tuple(normal(e) for e in tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in flat_specs(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in flat_specs(v)]
    assert tree is None, type(tree)
    return []


def same_specs(port, ref):
    got, want = flat_specs(port), flat_specs(ref)
    assert len(got) == len(want) > 0
    bad = [(i, g, w) for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not bad, bad[:5]


@functools.cache
def shapes(arch):
    """The reference's (params, AdamW state, Adafactor state, batches,
    caches) shape trees of an arch at full size."""
    cfg = R_CONFIGS[arch]
    params = jax.eval_shape(rreg.get_model(cfg).init, jax.random.PRNGKey(0))
    adamw = jax.eval_shape(radamw.adamw_init, params)
    adafactor = jax.eval_shape(radamw.adafactor_init, params)
    names = applicable_shapes(cfg)
    batches = {n: rreg.input_specs(cfg, R_SHAPES[n]) for n in names}
    caches = {n: rreg.decode_input_specs(cfg, R_SHAPES[n])["cache"]
              for n in names if R_SHAPES[n].kind == "decode"}
    return params, adamw, adafactor, batches, caches


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_axis_and_logical_spec(mesh):
    rmesh, tmesh_ = meshes(mesh)
    for logical in LOGICAL:
        assert api.resolve_axis(tmesh_, logical) == \
            rapi.resolve_axis(rmesh, logical), logical
    assert flat_specs(api.logical_spec(tmesh_, *LOGICAL)) == \
        flat_specs(rapi.logical_spec(rmesh, *LOGICAL))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    rmesh, tm = meshes(mesh)
    params = shapes(arch)[0]
    same_specs(sharding.param_specs(to_port(params), CONFIGS[arch], tm),
               rsh.param_specs(params, R_CONFIGS[arch], rmesh))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_the_reference(arch, mesh, opt):
    rmesh, tm = meshes(mesh)
    params, adamw, adafactor = shapes(arch)[:3]
    state = adamw if opt == "adamw" else adafactor
    got = sharding.opt_state_specs(to_port(state), to_port(params),
                                   CONFIGS[arch], tm)
    want = rsh.opt_state_specs(state, params, R_CONFIGS[arch], rmesh)
    assert type(got).__name__ == type(want).__name__
    same_specs(got, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh):
    rmesh, tm = meshes(mesh)
    _, _, _, batches, caches = shapes(arch)
    for batch in batches.values():
        same_specs(sharding.batch_specs(to_port(batch), tm),
                   rsh.batch_specs(batch, rmesh))
    assert caches
    for cache in caches.values():
        same_specs(sharding.cache_specs(to_port(cache), CONFIGS[arch], tm),
                   rsh.cache_specs(cache, R_CONFIGS[arch], rmesh))


def test_kv_model_and_indivisible_dims_replicate():
    """GQA k/v projections take 'model' only when the KV heads divide it;
    a dim the axis does not divide is replicated."""
    tm = {"data": 16, "model": 16}
    cfg = CONFIGS["granite-8b"]           # 8 KV heads on a 16-way axis
    assert tuple(sharding.spec_for_leaf(("attn", "wk"), (4096, 1024), cfg,
                                        tm)) == ("data", None)
    assert tuple(sharding.spec_for_leaf(("attn", "wq"), (4096, 4096), cfg,
                                        tm)) == ("data", "model")
    assert tuple(sharding.spec_for_leaf(("stacks", "mlp", "w_up"),
                                        (36, 4096, 12800), cfg, tm)) == \
        (None, "data", "model")
    assert tuple(sharding.spec_for_leaf(("head",), (4096, 49160), cfg,
                                        tm)) == ("data", None)


def test_use_mesh_nests_and_restores():
    a, b = {"data": 2}, {"data": 4}
    assert api.current_mesh() is None
    with api.use_mesh(a):
        assert api.current_mesh() is a
        with api.use_mesh(b):
            assert api.current_mesh() is b
        assert api.current_mesh() is a
    assert api.current_mesh() is None
    x = torch.ones(2)
    assert api.constrain(x, "dp", None) is x


def test_local_mesh_and_mesh_dict():
    """A process outside a launched world is a world of one rank: its
    local mesh is (data 1, model 1), as the reference's on one CPU
    device, and a production mesh refuses it."""
    created = not torch.distributed.is_initialized()
    mesh = tmesh.make_local_mesh()
    try:
        assert tmesh.mesh_dict(mesh) == r_mesh_dict(r_local_mesh())
        assert tmesh.mesh_dict(mesh) == {"data": 1, "model": 1}
        assert list(mesh.get_coordinate()) == [0, 0]
        with pytest.raises(ValueError, match="256 ranks; this one has 1"):
            tmesh.make_production_mesh()
        with pytest.raises(ValueError, match="512 ranks"):
            tmesh.make_production_mesh(multi_pod=True)
    finally:
        if created:
            torch.distributed.destroy_process_group()


def test_world_plan_picks_the_backend_once():
    assert tmesh.world_plan(4, "cpu") == ("gloo", [torch.device("cpu")] * 4)


def test_collectives_outside_a_body_are_unbound():
    with pytest.raises(NameError, match="unbound axis name: 'model'"):
        api.psum(torch.ones(2), "model")


def test_shard_map_refuses_inputs_that_require_grad():
    mesh = {"data": 1}
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="slice 3g"):
        api.shard_map(lambda v: v, mesh, (P(),), P())(x)


def test_a_world_runs_functions_until_closed():
    from _mesh_worlds import rank_and_world

    with tmesh.World(2, "cpu") as world:
        assert world.run(rank_and_world) == [(0, 2), (1, 2)]
        assert world.run(rank_and_world) == [(0, 2), (1, 2)]
    assert not any(p.is_alive() for p in world._procs)


def test_a_failing_rank_fails_the_run_and_stops_the_world():
    """Rank 1 raises while rank 0 waits in a barrier: the run raises with
    rank 1's traceback at once and no rank is left running."""
    from _mesh_worlds import fail_on_rank_one

    world = tmesh.World(2, "cpu")
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*on purpose"):
        world.run(fail_on_rank_one, timeout_s=120)
    assert not any(p.is_alive() for p in world._procs)
