"""Parity of the port's Mamba + attention + MoE hybrid with the
reference's on the CPU: reduced Jamba-v0.1 (a period of 8).  The tests
shared by the families, their tolerances and inputs are in
`tests/_lm_families.py`; this file gives their cases and holds the ones
of Jamba alone.
"""
import pytest
import torch
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
from _lm_parity import configs

from repro_torch.launch import serve as tlaunch
from repro_torch.models import transformer as ttr
from repro_torch.tree import leaves


@pytest.fixture(params=["jamba-v0.1-52b"])
def arch(request):
    return request.param


@pytest.fixture(params=[True, False])
def use_kernels(request):
    return request.param


@pytest.fixture(params=["moe_decode_weight_stationary", "sequence_parallel"])
def knob(request):
    return request.param


def test_slice_and_merge_cache_cover_every_leaf():
    """A slot's rows of every leaf -- K, V, Mamba h and conv -- move
    through slice_cache / merge_cache, the other slots untouched."""
    _, tc = configs("jamba-v0.1-52b", "float32")
    cache = ttr.init_cache(tc, 3, 8, "cpu")
    gen = torch.Generator().manual_seed(5)
    for t in leaves(cache):
        t.copy_(torch.randint(0, 9, t.shape, generator=gen).to(t.dtype))
    before = [t.clone() for t in leaves(cache)]
    sub = ttr.slice_cache(cache, 1)
    assert all(s.shape[0] == 1 for s in leaves(sub))
    for s, t in zip(leaves(sub), before):
        assert torch.equal(s[0], t[1])
    for s in leaves(sub):
        s.add_(1)
    ttr.merge_cache(cache, sub, 1)
    kinds = {name for layer in cache["layers"] for name in layer}
    assert kinds == {"kv", "ssm"}
    for t, b in zip(leaves(cache), before):
        assert torch.equal(t[1], b[1] + 1)
        assert torch.equal(t[0], b[0]) and torch.equal(t[2], b[2])


def test_launcher_layers_cuts_the_depth(capsys):
    out, _ = tlaunch.main(["--arch", "jamba-v0.1-52b", "--reduced",
                           "--layers", "5", "--requests", "2", "--max-new",
                           "4", "--device", "cpu"])
    assert len(out) == 2
    assert "on cpu" in capsys.readouterr().out
