"""Parity of the port's RWKV-6 decoder with the reference's on the CPU
(reduced RWKV-6; attention-free, so one route).  The tests shared by the
families, their tolerances and inputs are in `tests/_lm_families.py`;
this file gives their cases.
"""
import pytest
from _lm_families import (  # noqa: F401  (fixtures and shared tests)
    _restore_knobs, dtype, test_convert_round_trip_is_the_reference_tree,
    test_family_is_supported_with_the_reference_layout,
    test_forward_logits_and_aux_match_the_reference,
    test_gradients_match_the_reference,
    test_init_params_and_cache_have_the_reference_shapes,
    test_loss_fn_with_the_aux_loss_matches_the_reference,
    test_mesh_only_knob_changes_nothing_on_one_device,
    test_prefill_and_decode_match_the_reference,
    test_launcher_serves_the_family_on_the_cpu,
    test_prefill_padding_reaches_the_state_as_in_the_reference,
    test_remat_modes_give_the_same_loss_and_grads,
    test_served_tokens_equal_the_reference_engine)


@pytest.fixture(params=["rwkv6-3b"])
def arch(request):
    return request.param


@pytest.fixture(params=[True])
def use_kernels(request):
    """Attention-free RWKV has no kernel route to choose."""
    return request.param


@pytest.fixture(params=["rwkv_batch_shard"])
def knob(request):
    return request.param
