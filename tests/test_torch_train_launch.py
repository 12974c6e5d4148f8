"""The port's training checkpoints and launcher against the reference's
on the CPU: checkpoints of the train state cross both ways with equal
manifests and shard bytes, and `repro_torch.launch.train` resumes after
an injected crash (`tests/test_train_loop.py`'s launcher test) and from
the reference's launcher's checkpoint."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _lm_parity import configs, f32, shared_train_params

from repro.checkpoint.manager import CheckpointManager as RManager
from repro.launch import train as rlaunch
from repro.optim import OptimizerConfig as ROptimizerConfig
from repro.optim import make_optimizer as r_make_optimizer
from repro_torch.checkpoint import CheckpointManager
from repro_torch.device import to_tensor
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.optim import AdafactorState, AdamWState
from repro_torch.tree import leaves, tree_map


@pytest.fixture(autouse=True)
def one_thread():
    """These models are tiny: one intra-op thread a test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_state(opt, dtype="bfloat16"):
    """The reduced stablelm's (params, opt_state) at step 1: seeded
    nonzero values in every leaf of the reference's state."""
    rc, _ = configs("stablelm-1.6b", dtype)
    rparams, _ = shared_train_params(rc)
    init = r_make_optimizer(ROptimizerConfig(name=opt))[0]
    rng = np.random.default_rng(8)
    blank = init(rparams)
    filled = jax.tree.map(lambda z: jnp.asarray(
        rng.uniform(1e-4, 1e-2, z.shape), z.dtype), tuple(blank[1:]))
    return rparams, type(blank)(jnp.int32(1), *filled)


def _port_copy(rparams, rstate):
    """The same state as the port's tensors on the CPU."""
    params = tree_map(lambda a: to_tensor(np.asarray(a), "cpu"), rparams)
    return params, convert.opt_state_from_reference(
        jax.tree.map(np.asarray, rstate), "cpu")


def _same(port_leaf, ref_leaf):
    assert str(port_leaf.dtype).replace("torch.", "") == str(ref_leaf.dtype)
    assert tuple(port_leaf.shape) == ref_leaf.shape
    assert np.array_equal(f32(port_leaf), f32(ref_leaf))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_checkpoint_of_the_train_state_crosses_both_ways(opt):
    rparams, rstate = _reference_state(opt)
    params, state = _port_copy(rparams, rstate)
    assert type(state) is {"adamw": AdamWState,
                           "adafactor": AdafactorState}[opt]
    with tempfile.TemporaryDirectory() as d:
        ours = CheckpointManager(os.path.join(d, "port"))
        theirs = RManager(os.path.join(d, "ref"), codec="zlib")
        ours.save(1, (params, state))
        theirs.save(1, (rparams, rstate), blocking=True)
        # the same manifest and shard bytes
        assert ours.load_manifest(1) == theirs.load_manifest(1)
        names = ("step_000000001/shard_00000.bin.zlib",
                 "step_000000001/manifest.msgpack")
        for name in names:
            with open(os.path.join(d, "port", name), "rb") as a, \
                    open(os.path.join(d, "ref", name), "rb") as b:
                assert a.read() == b.read()
        # the reference reads the port's, the port reads the reference's
        blank = jax.tree.map(jnp.zeros_like, (rparams, rstate))
        (rp, rs), step = RManager(os.path.join(d, "port")).restore(1, blank)
        assert step == 1
        for got, want in zip(jax.tree.leaves((rp, rs)),
                             jax.tree.leaves((rparams, rstate))):
            assert got.dtype == want.dtype
            assert np.array_equal(f32(got), f32(want))
        zeros = tree_map(torch.zeros_like, (params, state))
        (tp, ts), step = CheckpointManager(os.path.join(d, "ref")).restore(
            1, zeros)
        assert step == 1 and type(ts) is type(state)
        assert int(ts.step) == int(rstate.step) == 1
        for got, want in zip(leaves((tp, ts)),
                             jax.tree.leaves((rparams, rstate))):
            _same(got, want)


def test_non_blocking_save_commits_after_wait():
    _, tparams = shared_train_params(configs("granite-8b", "float32")[0])
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for step in (3, 6, 9):
            mgr.save(step, {"params": tparams}, blocking=False)
        mgr.wait()
        assert mgr.committed_steps() == [6, 9]
        got, step = mgr.restore(None, {"params": tparams})
        assert step == 9
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(got), leaves({"params": tparams})))


def _port_run(ckpt, fail_at=-1, steps=12):
    return tlaunch.main([
        "--arch", "stablelm-1.6b", "--reduced", "--steps", str(steps),
        "--batch", "2", "--seq", "16", "--ckpt-dir", ckpt,
        "--ckpt-every", "4", "--log-every", "100",
        "--fail-at-step", str(fail_at), "--device", "cpu"])


def test_launcher_crash_restart_deterministic():
    """launch.train with an injected crash must resume from the checkpoint
    and reach the same final state as an uninterrupted run."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        clean = _port_run(d1)
        crashed = _port_run(d2, fail_at=7)
        # the final checkpoints hold the same state, byte for byte
        finals = []
        for d in (d1, d2):
            with open(os.path.join(d, "step_000000011",
                                   "shard_00000.bin.zlib"), "rb") as f:
                finals.append(f.read())
    assert clean[-1][0] == crashed[-1][0] == 11
    assert clean[-1][1] == pytest.approx(crashed[-1][1], rel=1e-5)
    assert [s for s, _ in crashed] == list(range(7)) + list(range(5, 12))
    assert finals[0] == finals[1]


def test_launcher_checkpoints_cross_the_packages(capsys):
    """The reference's launcher resumes from the port's checkpoint of the
    same config, and the port's launcher from the reference's."""
    with tempfile.TemporaryDirectory() as d:
        _port_run(d, steps=8)
        capsys.readouterr()
        rlaunch.main(["--arch", "stablelm-1.6b", "--reduced", "--steps",
                      "10", "--batch", "2", "--seq", "16", "--ckpt-dir", d,
                      "--log-every", "100"])
        assert "restored step 7" in capsys.readouterr().out
        losses = _port_run(d, steps=12)
        assert "restored step 9" in capsys.readouterr().out
    assert [s for s, _ in losses] == [10, 11]
    assert all(np.isfinite(v) for _, v in losses)


def _mesh_args(ckpt, steps, fail_at=-1):
    return ["--arch", "stablelm-1.6b", "--reduced", "--steps", str(steps),
            "--batch", "8", "--seq", "16", "--ckpt-dir", ckpt,
            "--ckpt-every", "2", "--log-every", "100", "--fail-at-step",
            str(fail_at), "--device", "cpu"]


def test_launcher_trains_on_a_mesh_and_resumes(capsys):
    """`--model-parallel 2` on an 8-rank CPU world (data 4, model 2):
    a run killed at step 3 resumes from its step-2 checkpoint and ends as
    an uninterrupted run does (the same losses on every rank, the same
    final checkpoint bytes); the mesh's checkpoint, global arrays
    assembled from the blocks, resumes on one rank as on the mesh: the
    same losses to `tests/test_torch_train.py`'s bfloat16 bar (rel 1e-3;
    the reduced config trains in bfloat16, its products summed in
    another order on each mesh)."""
    from _mesh_train import launcher_rank
    from repro_torch.launch.mesh import World

    mp = ["--model-parallel", "2"]
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        with World(8, "cpu") as world:
            clean = world.run(launcher_rank, (_mesh_args(d1, 6) + mp,))
            crashed = world.run(launcher_rank,
                                (_mesh_args(d2, 6, fail_at=3) + mp,))
            on_mesh = world.run(launcher_rank, (_mesh_args(d1, 8) + mp,))
        finals = []
        for d in (d1, d2):
            with open(os.path.join(d, "step_000000005",
                                   "shard_00000.bin.zlib"), "rb") as f:
                finals.append(f.read())
        capsys.readouterr()
        one_rank = tlaunch.main(_mesh_args(d2, 8))
        assert "restored step 5" in capsys.readouterr().out
    assert all(r == clean[0] for r in clean + crashed)
    assert [s for s, _ in clean[0]] == list(range(6))
    assert finals[0] == finals[1]
    assert [s for s, _ in on_mesh[0]] == [s for s, _ in one_rank] == [6, 7]
    for (_, a), (_, b) in zip(on_mesh[0], one_rank):
        assert a == pytest.approx(b, rel=1e-3)


def test_launcher_refuses_model_parallel():
    """A family outside the partitioned step's refuses a model axis."""
    with pytest.raises(NotImplementedError, match="slice 3g"):
        tlaunch.main(["--arch", "jamba-v0.1-52b", "--reduced",
                      "--model-parallel", "2", "--device", "cpu"])


def test_launcher_model_axis_must_divide_the_world():
    """Outside a world the launcher's world is one rank: a model axis of
    2 raises, and the one-rank group it started is gone."""
    with pytest.raises(ValueError, match="does not divide this world of 1"):
        tlaunch.main(["--reduced", "--model-parallel", "2", "--device",
                      "cpu"])
    assert not torch.distributed.is_initialized()


def test_a_background_save_error_is_raised_by_wait():
    with tempfile.TemporaryDirectory() as d:
        blocker = os.path.join(d, "file")
        with open(blocker, "w") as f:
            f.write("not a directory")
        mgr = CheckpointManager(blocker)
        mgr.save(1, {"x": torch.zeros(3)}, blocking=False)
        with pytest.raises(OSError):
            mgr.wait()
        mgr.wait()                      # reported once
        with pytest.raises(OSError):
            mgr.save(2, {"x": torch.zeros(3)})
