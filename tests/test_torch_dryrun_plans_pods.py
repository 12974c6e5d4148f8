"""Parity of the port's step plans with the reference's on the two-pod
production mesh (2, 16, 16) (`_dryrun_plans.check_plan`): every cell's
input shapes and dtypes, spec trees and `donate`.
"""
import pytest

from _dryrun_plans import check_plan
from test_torch_dryrun import CELLS


@pytest.mark.parametrize("arch,shape", CELLS)
def test_plan_specs_and_donations_equal_the_reference(arch, shape):
    check_plan(arch, shape, "2x16x16")
