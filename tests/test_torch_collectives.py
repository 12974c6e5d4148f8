"""Parity of the port's collectives (`repro_torch.distributed`'s
`collectives`, `pipeline`, and `optim.grad_compress`'s cross-pod
all-reduce) with the reference's, on the same meshes.

The port's meshes live in one 8-rank gloo world on the CPU; the
reference runs the same shard_map bodies once per file in a subprocess
with eight host devices (`tests/_mesh_reference.py`):
  (data 2, model 4)        ring all-gather matmul, LSE-merged decode
                           attention (GQA, seeded valid lengths),
                           reduce_scatter_grads (scattered, summed and
                           scalar leaves)
  (pod 2, data 4) and
  (pod 2, data 2, model 2) the int8 cross-pod all-reduce, each pod its
                           own gradients and residuals
  (data 2, stage 4)        the GPipe schedule on the reference's toy MLP
float32 within 1e-4, the reference's own bound
(`tests/test_multidevice.py:63-64`, `tests/test_pipeline.py`); the
cross-pod payloads and residuals bit for bit against the formula
evaluated on one process.
"""
import types

import numpy as np
import pytest
import torch
from _mesh_worlds import (BLOCK_MESH, BLOCK_SPECS, WORLD, collective_inputs,
                          collectives_world, finish, run_reference)

from repro_torch.distributed import sharding
from repro_torch.distributed.api import P
from repro_torch.distributed.pipeline import PipelineConfig
from repro_torch.launch.mesh import launch
from repro_torch.optim import grad_compress

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    inputs, out = d / "inputs.npz", d / "reference.npz"
    np.savez(inputs, **collective_inputs())
    proc = run_reference("collectives", inputs, out)
    ref = finish(proc, out)          # the pipeline's weights come from it
    ranks = launch(collectives_world, WORLD, device="cpu",
                   args=(str(inputs), ref["pipe_weights"]))
    return ref, ranks, collective_inputs()


def test_ring_allgather_matmul(worlds):
    ref, ranks, inp = worlds
    np.testing.assert_allclose(ranks[0]["ring"], ref["ring"], **TOL)
    np.testing.assert_allclose(ranks[0]["ring"],
                               inp["ring_x"] @ inp["ring_w"], **TOL)


def test_lse_merge_attention(worlds):
    ref, ranks, inp = worlds
    np.testing.assert_allclose(ranks[0]["lse"], ref["lse"], **TOL)
    # plain softmax attention over the valid keys, GQA heads repeated
    q = torch.from_numpy(inp["lse_q"])
    k = torch.from_numpy(inp["lse_k"]).repeat_interleave(2, dim=2)
    v = torch.from_numpy(inp["lse_v"]).repeat_interleave(2, dim=2)
    s = torch.einsum("bhqd,bshd->bhqs", q, k) / 16 ** 0.5
    s = s.masked_fill(~torch.from_numpy(inp["lse_valid"])[:, None, None],
                      -torch.inf)
    want = torch.einsum("bhqs,bshd->bhqd", s.softmax(-1), v)
    np.testing.assert_allclose(ranks[0]["lse"], want.numpy(), **TOL)


@pytest.mark.parametrize("leaf", ["a", "b", "c"])
def test_reduce_scatter_grads(worlds, leaf):
    """a (8, 3): each member keeps 2 rows of the sum (assembled back);
    b (5,) does not split in 4 and c is a scalar: summed."""
    ref, ranks, inp = worlds
    np.testing.assert_allclose(ranks[0][f"rs_{leaf}"], ref[f"rs_{leaf}"],
                               **TOL)
    np.testing.assert_allclose(ranks[0][f"rs_{leaf}"],
                               inp[f"rs_{leaf}"].sum(0), **TOL)


def crosspod_on_one_process(inp):
    """The formula with both pods' inputs in one process: quantize each
    pod, sum the int8 payloads in int32, average the scales."""
    outs, resid = [], []
    for pod in range(2):
        g = {"w": torch.from_numpy(inp["cp_w"][pod]),
             "b": torch.from_numpy(inp["cp_b"][pod])}
        r = {"w": torch.from_numpy(inp["cp_rw"][pod]),
             "b": torch.from_numpy(inp["cp_rb"][pod])}
        q, s, st = grad_compress.compress_grads(
            g, grad_compress.CompressionState(residual=r))
        outs.append((q, s))
        resid.append(st.residual)
    red = {k: (outs[0][0][k].to(torch.int32) + outs[1][0][k].to(torch.int32)
               ).float() * ((outs[0][1][k] + outs[1][1][k]) / 2) / 2
           for k in ("w", "b")}
    return red, {k: torch.stack([r[k] for r in resid]) for k in ("w", "b")}


@pytest.mark.parametrize("mesh", ["pd", "pdm"])
@pytest.mark.parametrize("leaf", ["w", "b"])
def test_crosspod_allreduce_compressed(worlds, mesh, leaf):
    ref, ranks, inp = worlds
    red, resid = crosspod_on_one_process(inp)
    got = ranks[0][f"cp_{mesh}_{leaf}"]
    assert np.array_equal(got, red[leaf].numpy())
    assert np.array_equal(ranks[0][f"cp_{mesh}_r{leaf}"],
                          resid[leaf].numpy())
    for other in ranks[1:]:
        assert np.array_equal(other[f"cp_{mesh}_{leaf}"], got)
    np.testing.assert_allclose(got, ref[f"cp_{mesh}_{leaf}"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ranks[0][f"cp_{mesh}_r{leaf}"],
                               ref[f"cp_{mesh}_r{leaf}"], rtol=1e-5,
                               atol=1e-7)


def test_pipeline_apply(worlds):
    """4 stages x 8 microbatches: the last stage's block holds the
    outputs, equal to the sequential oracle and to the reference's."""
    ref, ranks, _ = worlds
    got = ranks[0]["pipe"].reshape(4, 8, 4, 16)[-1]
    want = ref["pipe"].reshape(4, 8, 4, 16)[-1]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, ranks[0]["pipe_oracle"], **TOL)
    np.testing.assert_allclose(got, ref["pipe_oracle"], **TOL)
    assert not ranks[0]["pipe"].reshape(4, 8, 4, 16)[:-1].any()


def test_schedule_accounting():
    cfg = PipelineConfig(n_stages=4, n_microbatches=12)
    assert cfg.n_ticks == 15
    assert cfg.bubble_fraction == pytest.approx(3 / 15)


def test_mesh_coordinates_are_row_major(worlds):
    """Rank r sits at (r // 4, r % 4) of the (data 2, model 4) mesh, as
    `init_device_mesh` numbers ranks, and gloo stages CUDA tensors
    through the host."""
    _, ranks, _ = worlds
    assert [tuple(r["rank_coordinate"]) for r in ranks] == \
        [(r // 4, r % 4) for r in range(WORLD)]
    assert {r["transport"] for r in ranks} == {"host"}


def stand_in(shape, axes, coord):
    """What `block_of` reads of a DeviceMesh, at one coordinate."""
    return types.SimpleNamespace(
        mesh_dim_names=axes, mesh=types.SimpleNamespace(shape=shape),
        get_local_rank=lambda name: coord[axes.index(name)])


@pytest.mark.parametrize("i", range(len(BLOCK_SPECS)))
def test_block_order_is_named_shardings(worlds, i):
    """Every coordinate of a (pod 2, data 2, model 2) mesh: the block the
    port cuts for a spec (row-major over an entry's axes) is the one
    `NamedSharding` gives the device there."""
    ref = worlds[0][f"blocks_{i}"]
    x = torch.arange(64).reshape(8, 8)
    for j, coord in enumerate(np.ndindex(*BLOCK_MESH[0])):
        got = sharding.block_of(x, P(*BLOCK_SPECS[i]),
                                stand_in(*BLOCK_MESH, coord))
        (r0, r1), (c0, c1) = ref[j]
        assert torch.equal(got, x[r0:r1, c0:c1]), coord
