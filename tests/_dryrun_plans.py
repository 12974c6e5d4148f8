"""Parity of the port's step plans (`repro_torch.launch.steps.build_plan`)
with the reference's, for the three `test_torch_dryrun_plans*.py` files
(one mesh each, so that the test runner can spread them): for every
(arch x applicable shape) cell at full size, on `AbstractMesh` (16, 16),
(2, 16, 16) or (2, 4), the inputs' shapes and dtypes, the in and out
spec trees and `donate` equal the reference's.  (The port's meshes are
plain {axis: size} dicts, which its sharding rules take; the plans'
inputs are fake tensors.)
"""
import jax
from jax.sharding import AbstractMesh

from test_torch_dryrun import _ref_shapes, _shapes
from test_torch_mesh import flat_specs
from repro.configs import CONFIGS as R_CONFIGS, SHAPES as R_SHAPES
from repro.launch import steps as rsteps
from repro_torch.configs import CONFIGS, SHAPES
from repro_torch.launch import steps
from repro_torch.tree import leaves

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def _ref_specs(tree):
    """A NamedSharding tree as its PartitionSpecs (None stays None)."""
    return jax.tree.map(lambda s: s.spec, tree)


def check_plan(arch, shape, mesh):
    """The port's plan of a cell on a mesh against the reference's."""
    dims, axes = MESHES[mesh]
    port = steps.build_plan(CONFIGS[arch], SHAPES[shape],
                            dict(zip(axes, dims)))
    ref = rsteps.build_plan(R_CONFIGS[arch], R_SHAPES[shape],
                            AbstractMesh(dims, axes))
    assert port.kind == ref.kind and port.donate == ref.donate
    assert len(port.in_specs) == len(ref.in_specs)
    for p, r in zip(port.in_specs, ref.in_specs):
        assert _shapes(p) == _ref_shapes(r)
    got_in = [flat_specs(t) for t in port.in_shardings]
    want_in = [flat_specs(_ref_specs(t)) for t in ref.in_shardings]
    assert got_in == want_in
    assert [len(s) for s in got_in] == [len(leaves(t))
                                       for t in port.in_specs]
    assert len(port.out_shardings) == len(ref.out_shardings)
    for p, r in zip(port.out_shardings, ref.out_shardings):
        assert (p is None) == (r is None)
        if p is not None:
            assert flat_specs(p) == flat_specs(_ref_specs(r))
