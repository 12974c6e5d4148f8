"""Parity of the port's MoE mesh paths (`repro_torch.models.moe`'s
`apply_moe_sharded`, `apply_moe_a2a` and `apply_moe_decode`) with the
reference's on a (data 2, model 4) mesh.

The port's mesh is an 8-rank gloo world on the CPU
(`repro_torch.launch.mesh.launch`); the reference runs the same cases
once per file in a subprocess with eight host devices
(`tests/_mesh_reference.py`).  Both read one npz of inputs and write
their results; the parametrised tests compare them case by case
(`apply_moe_auto`'s branches: `tests/test_torch_mesh_auto.py`).
Routing is exact in both (one-hot tokens through a router whose rows
are the logits), so every shard keeps and drops the same slots: at the
reduced Jamba, Arctic and Kimi K2 configs' own capacity factor 1.25,
where the shards drop, as at 8, where none does.  float32 within
rtol 1e-5 (the decode path's combine is a bfloat16 psum in both
packages, `moe.py:417` of the reference: one bfloat16 ulp), bfloat16
within `TOL`; every rank holds the same result, and a replay is bit
for bit the first run.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from _lm_parity import TOL
from _mesh_worlds import (MOE_ARCHS, check_case, moe_config, moe_inputs,
                          moe_worlds, parse, path_cases)

from repro.configs import CONFIGS as R_CONFIGS
from repro.models import moe as rmoe


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(the reference's results, every port rank's results)."""
    return moe_worlds(tmp_path_factory.mktemp("mesh_moe"), "paths")


@pytest.mark.parametrize("case", path_cases())
def test_mesh_path_matches_the_reference(worlds, case):
    assert check_case(worlds, case, TOL["bfloat16"]) == parse(case)[3]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_is_each_shards_own(worlds, arch):
    """At capacity factor 8 the sharded path equals the global layer; at
    1.25 each shard's own capacity drops slots the global one keeps (in
    both packages), so the two differ."""
    ranks = worlds[1]
    inp = moe_inputs(arch)
    p = {k[2:]: jnp.asarray(v) for k, v in inp.items()
         if k.startswith("p_")}
    for cf, differs in ((8.0, False), (1.25, True)):
        rc = moe_config(arch, cf, "float32", R_CONFIGS)
        want, _ = rmoe.apply_moe(p, rc, jnp.asarray(inp["x_prefill"]))
        got = ranks[0][f"{arch}|{cf}|float32|sharded"][0]
        gap = float(np.abs(got - np.asarray(want)).max())
        assert (gap > 1e-3) == differs, gap
