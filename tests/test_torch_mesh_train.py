"""Parity of the partitioned train step (`repro_torch.distributed.
partition`, `distributed.autograd`) with the reference's SPMD step:
StableLM's reduced config on (data 2, model 4) and (data 4, model 2).

The reference jits `repro.launch.steps.build_train_plan` on eight host
devices in a subprocess (`tests/_mesh_train_reference.py`); the port
runs the same N_STEPS float32 steps on an 8-rank gloo world on the CPU,
each rank on its blocks (`tests/_mesh_train.py`).  Held: loss and
gradient norm within rel 1e-5 at every step; step 1's gradients (AdamW's
`mu / (1 - b1)`) within 1e-4 of each leaf's max; the updated parameters
and optimizer state to `tests/test_torch_train.py`'s float32 bars, with
its `sign_noise` mask; the loss, the norm and every replicated leaf the
same bits on every rank; prefill and decode logits of the partitioned
forward against the port's one-rank forward.  Also here: each
differentiable collective's backward against its closed form on two
ranks.  The GQA and bias configs: `test_torch_mesh_train_gqa.py`,
`test_torch_mesh_train_bias.py`.
"""
import numpy as np
import pytest
import _mesh_train as W

CASES = [W.case_name("stablelm-1.6b", shape) for shape in ((2, 4), (4, 2))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return W.worlds(tmp_path_factory.mktemp("mesh_train"), CASES)


@pytest.mark.parametrize("case", CASES)
def test_loss_and_grad_norm_match_the_reference(worlds, case):
    W.check_metrics(worlds, case)


@pytest.mark.parametrize("case", CASES)
def test_step_one_gradients_match_the_reference(worlds, case):
    W.check_gradients(worlds, case)


@pytest.mark.parametrize("case", CASES)
def test_parameters_and_state_match_the_reference(worlds, case):
    W.check_state(worlds, case)


@pytest.mark.parametrize("case", CASES)
def test_replicated_values_are_the_same_bits_on_every_rank(worlds, case):
    W.check_replicated(worlds, case)


@pytest.mark.parametrize("case", CASES)
def test_partitioned_forward_matches_one_rank(worlds, case):
    W.check_forward(worlds, case)


# ---------------------------------------------------------------------------
# The differentiable collectives
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collectives():
    from repro_torch.launch.mesh import launch
    return launch(W.collectives_rank, 2, device="cpu")


def _x(shape, rank):
    return np.arange(float(np.prod(shape))).reshape(shape) * (1 + 10 * rank)


W_ = [np.arange(24.0).reshape(4, 6) * (r + 1) for r in range(2)]


@pytest.mark.parametrize("name,shape,dim", [("gather0", (2, 6), 0),
                                            ("gather1", (4, 3), 1)])
def test_all_gather_backward_is_a_reduce_scatter(collectives, name, shape,
                                                 dim):
    """y = the blocks in mesh order; dL/dx_r = member r's chunk of the sum
    of the members' cotangents."""
    total = W_[0] + W_[1]
    for r, (out, _) in enumerate(collectives):
        y, gx = out[name]
        np.testing.assert_array_equal(
            y, np.concatenate([_x(shape, 0), _x(shape, 1)], axis=dim))
        want = np.split(total, 2, axis=dim)[r]
        np.testing.assert_array_equal(gx, want)


def test_psum_backward_is_the_identity(collectives):
    for r, (out, _) in enumerate(collectives):
        y, gx = out["psum"]
        np.testing.assert_array_equal(y, _x((4, 6), 0) + _x((4, 6), 1))
        np.testing.assert_array_equal(gx, W_[r])


def test_enter_backward_is_a_psum(collectives):
    for r, (out, _) in enumerate(collectives):
        y, gx = out["enter"]
        np.testing.assert_array_equal(y, _x((4, 6), r))
        np.testing.assert_array_equal(gx, W_[0] + W_[1])


def test_pmax_carries_no_gradient(collectives):
    for r, (out, _) in enumerate(collectives):
        y, gx = out["pmax"]
        np.testing.assert_array_equal(
            y, np.maximum(_x((4, 6), 0), _x((4, 6), 1)) + _x((4, 6), r))
        np.testing.assert_array_equal(gx, W_[r])


def test_backward_exchanges_are_observed(collectives):
    """The roofline's counter sees the backward's collectives with the
    reference's names: the gathers' reduce-scatters of the full
    cotangent, psum's forward and enter's backward all-reduces."""
    _, seen = collectives[0]
    f32 = 4
    assert seen == [("all-gather", 4 * 6 * f32),
                    ("reduce-scatter", 4 * 6 * f32),
                    ("all-gather", 4 * 6 * f32),
                    ("reduce-scatter", 4 * 6 * f32),
                    ("all-reduce", 2 * 4 * 6 * f32),
                    ("all-reduce", 2 * 4 * 6 * f32),
                    ("all-reduce", 2 * 4 * 6 * f32)]
