"""The port's fused plan against the reference's fused plan at the
asymmetric split (n1, n2) = (32, 64): the batched callables
(make_batched(2)); see test_torch_fused_plan.py, whose check this file
runs."""

import pytest

from test_torch_fused_plan import CALLABLES, check_callable


@pytest.mark.parametrize("name", CALLABLES)
def test_fused_plan_matches_reference_plan_asymmetric_batched(name):
    check_callable(11, 5, name, batched=True)
