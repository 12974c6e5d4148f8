"""Parity of the port's `apply_moe_auto` (`repro_torch.models.moe`) with
the reference's: each branch -- the all-to-all, sharded and
weight-stationary paths, and the global layer for an odd batch, a mesh
without a model axis and no mesh -- for the reduced Jamba, Arctic and
Kimi K2 configs at capacity factor 8 and at their own 1.25, in an
8-rank gloo world on the CPU against the reference on eight host
devices in a subprocess (`tests/_mesh_worlds.py`,
`tests/_mesh_reference.py`); and the mesh paths on a one-device mesh in
this process against the reference's `make_local_mesh()` (the
counterparts of `tests/test_tuning.py:112-139`).  float32 within rtol
1e-5 (decode: one bfloat16 ulp, its combine's bfloat16 psum); every
rank the same bits; a replay bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import TOL
from _mesh_worlds import (AUTO, auto_cases, check_case, moe_config,
                          moe_worlds, parse)

from repro.distributed.api import use_mesh as r_use_mesh
from repro.launch.mesh import make_local_mesh as r_local_mesh
from repro.configs import CONFIGS as R_CONFIGS
from repro.models import moe as rmoe
from repro_torch.distributed.api import use_mesh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe as tmoe


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(the reference's results, every port rank's results)."""
    return moe_worlds(tmp_path_factory.mktemp("mesh_auto"), "auto")


@pytest.mark.parametrize("case", auto_cases())
def test_auto_branch_matches_the_reference(worlds, case):
    """apply_moe_auto takes the reference's branch (the port counts its
    mesh paths' calls), and its output is that path's, bit for bit."""
    route = AUTO[parse(case)[3][5:]][3]
    assert check_case(worlds, case, TOL["bfloat16"]) == route


# ---------------------------------------------------------------------------
# the one-device mesh in this process (tests/test_tuning.py:112-139)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def local_mesh():
    mesh = make_local_mesh()
    yield mesh
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("path", ["sharded", "a2a", "decode"])
def test_one_device_mesh_matches_the_reference(local_mesh, path):
    """Jamba (decode) and Kimi K2 (prefill) at capacity factor 8 in
    bfloat16 on a one-device mesh in both packages: each path within
    `TOL` of the reference's, and of the global layer (the reference
    test's rtol 0.05)."""
    arch = "jamba-v0.1-52b" if path == "decode" else "kimi-k2-1t-a32b"
    rc = moe_config(arch, 8.0, "bfloat16", R_CONFIGS)
    tc = moe_config(arch, 8.0, "bfloat16")
    rp = rmoe.init_moe(jax.random.PRNGKey(0), rc)
    shape = (4, 1) if path == "decode" else (2, 16)
    x = jax.random.normal(jax.random.PRNGKey(1), shape + (rc.d_model,),
                          dtype=jnp.bfloat16)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else torch.bfloat16)
        for k, v in rp.items()}
    tx = torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)
    fn = getattr(rmoe, f"apply_moe_{path}")
    with r_use_mesh(r_local_mesh()):
        want, waux = jax.jit(lambda p, x: fn(p, rc, x))(rp, x)
    with use_mesh(local_mesh):
        got, aux = getattr(tmoe, f"apply_moe_{path}")(tp, tc, tx)
    glob, _ = tmoe.apply_moe(tp, tc, tx)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **TOL["bfloat16"])
    np.testing.assert_allclose(got.float().numpy(), glob.float().numpy(),
                               rtol=0.05, atol=0.05)
    for k in waux:
        np.testing.assert_allclose(float(aux[k]), float(waux[k]),
                                   **TOL["bfloat16"])
