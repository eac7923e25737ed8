"""The port's inverse fused transform against the reference Pallas kernel
(interpret mode) at the nested splits, up to the full n = 2^20 width; see
test_torch_fused.py, whose check this file runs."""

import pytest

from test_torch_fused import NESTED_SHAPES, OPERANDS, \
    check_plain_against_reference


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("n1,n2", NESTED_SHAPES)
def test_plain_fused_inverse_matches_pallas_nested(n1, n2, operands, B):
    check_plain_against_reference(n1, n2, True, operands, B)
