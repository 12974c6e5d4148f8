"""Parity of the port's MoE decoders with the reference's on the CPU:
reduced Arctic (MoE with a dense residual) and Kimi K2 (a dense prefix
layer, a shared expert), and the tuning profiles.  The tests shared by
the families, their tolerances and inputs are in `tests/_lm_families.py`;
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
    test_prefill_and_decode_match_the_reference)

from repro.models import tuning as rtuning
from repro_torch.models import tuning as ttuning


@pytest.fixture(params=["arctic-480b", "kimi-k2-1t-a32b"])
def arch(request):
    return request.param


@pytest.fixture(params=[True, False])
def use_kernels(request):
    return request.param


@pytest.fixture(params=["moe_all_to_all", "moe_combine_bf16"])
def knob(request):
    return request.param


def test_tuning_profiles_equal_the_reference():
    assert ttuning._PROFILES == rtuning._PROFILES
    for name in ("baseline", "optimized"):
        ttuning.set_profile(name)
        rtuning.set_profile(name)
        assert ttuning.snapshot() == rtuning.snapshot()
    ttuning.set_knob("rwkv_chunked_scan", False)
    assert not ttuning.snapshot()["rwkv_chunked_scan"]
    with pytest.raises(KeyError):
        ttuning.set_knob("no_such_knob", True)
