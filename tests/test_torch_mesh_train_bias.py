"""Parity of the partitioned train step with the reference's SPMD step
for Qwen2's reduced config (qkv biases: bq split over `model`, bk / bv
with their KV heads) and StarCoder2's (GELU, LayerNorm, qkv biases), on
(data 4, model 2).  The checks are `tests/test_torch_mesh_train.py`'s
(`tests/_mesh_train.py`).
"""
import pytest
import _mesh_train as W

CASES = [W.case_name(arch, (4, 2))
         for arch in ("qwen2-72b", "starcoder2-15b")]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return W.worlds(tmp_path_factory.mktemp("mesh_train_bias"), CASES)


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
