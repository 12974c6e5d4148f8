"""Parity of the partitioned train step with the reference's SPMD step
for Granite's reduced config (GQA, 2 KV heads): on (data 2, model 4) the
rules replicate wk / wv and each rank reads the KV head its query head
maps to; on (data 4, model 2) they split.  The checks are
`tests/test_torch_mesh_train.py`'s (`tests/_mesh_train.py`).
"""
import pytest
import _mesh_train as W

CASES = [W.case_name("granite-8b", shape) for shape in ((2, 4), (4, 2))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return W.worlds(tmp_path_factory.mktemp("mesh_train_gqa"), CASES)


def test_the_kv_heads_split_on_one_mesh_only(worlds):
    ranks = worlds[1]
    assert [ranks[0][c]["kv_split"] for c in CASES] == [False, True]


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
