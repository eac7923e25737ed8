"""The port's fused plan against the reference's fused plan at an
asymmetric split (n1, n2) = (32, 64), where a swap of the two sides or
of an operand's orientation shows: the unbatched callables; see
test_torch_fused_plan.py, whose check this file runs."""

import pytest

from test_torch_fused_plan import CALLABLES, check_callable


@pytest.mark.parametrize("name", CALLABLES)
def test_fused_plan_matches_reference_plan_asymmetric(name):
    check_callable(11, 5, name, batched=False)
