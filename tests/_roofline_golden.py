"""The torch program of `tests/test_roofline.py`'s golden HLO module: a
10-iteration loop of an (8, 16) x (16, 16) matmul and a psum over
"data", then a (32, 64) x (64, 8) matmul.  `golden_rank` runs it on a
rank of a launched world (`launch.mesh.World`) under the cost counter
and returns what it counted."""
import torch

from repro_torch.distributed import api
from repro_torch.distributed.api import P
from repro_torch.roofline.op_costs import CostCounter


def golden_program(psum=None):
    x = torch.ones(8, 16)
    w = torch.ones(16, 16)
    for _ in range(10):
        y = x @ w
        x = psum(y, "data") if psum is not None else y
    big = torch.ones(32, 64)
    v = torch.ones(64, 8)
    big @ v
    return x


def golden_rank(rank):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2,), ("data",))
    body = api.shard_map(lambda a: golden_program(api.psum), mesh, (P(),),
                         P())
    with CostCounter() as cc:
        body(torch.zeros(1))
    c = cc.costs()
    return (c.matmul_flops, dict(c.collective_bytes),
            dict(c.collective_counts), c.flops)
