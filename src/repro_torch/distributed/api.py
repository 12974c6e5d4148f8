"""Sharding-constraint helper used inside model code: the counterpart of
`repro.distributed.api`, `constrain` alone.

Model code calls `constrain(x, "dp", None, "model")` with logical axis
names.  The reference turns that into a sharding constraint when the
launch layer has installed a mesh, and into the identity otherwise.  The
port has no meshes yet (ROADMAP A11, slice 3c), so it is the identity.
"""
from __future__ import annotations

import torch


def constrain(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """The identity: no mesh is ever active in the port."""
    return x
